"""The train step: the plain data-parallel step or the ACPD grouped delta exchange.

PyTorch counterpart of ``repro.launch.steps.build_train_step`` on one card.
:func:`build_train_step` returns ``step(params, opt_state, exch_state,
batch) -> (params, opt_state, exch_state, metrics)`` with the JAX step's
semantics:

* ``setup.exchange is None``: the loss and its gradient over the whole
  batch (the synchronous mean-gradient baseline), then the optimizer;
* otherwise the monitored loss is the loss of the whole batch (a forward
  only), then the batch is split into ``num_groups`` row groups and
  ``core.exchange.exchange_sequential`` takes one group's gradient at a
  time, then the optimizer applies the exchanged update.

The optimizer and the sequential exchange update their state in place and
return it (see ``optim.optimizers`` and ``core.exchange``), and so does the
step: the returned trees hold the tensors it was given. Every attention
layer runs the flash kernel: with the exchange, once per layer in the
monitored forward and, under ``remat``, twice per layer for each group
(forward and recompute), (1 + 2K) x layers launches a step.

``TrainSetup.exploit_window`` is the JAX package's option of that name:
False runs the windowed layers as its baseline (``models.attention``), the
same loss and gradients at more work.

On the card, a loss that makes no host sync (a config whose attention does
not copy its scale from the host, ``cfg.copies_attn_scale`` false: HuBERT's
and the held-experts decoder's) has its loss and gradient, forward, remat's
recompute and backward,
taken as one captured CUDA graph (:class:`GradGraphs`) per batch shape and
replayed every step: the host then issues a few hundred launches a step
where it issued tens of thousands, and a deep model's step is bound by the
card rather than by the host.

The mesh is not ported (ROADMAP A7): sequence sharding, ZeRO-1 and FSDP
have nothing to shard over on one card, and asking for them raises
(``launch/mesh.py`` ports only the mesh's shape arithmetic). The JAX
package's ``profile`` and ``sequential_exchange`` options have no
counterpart: the rule tables need the mesh, and the step always takes the
sequential exchange (K stacked gradients would not fit beside the
residuals at full width).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import exchange as exch_lib
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import train_loss
from repro_torch.models.param import tree_flatten
from repro_torch.optim.optimizers import OptimizerConfig, apply_update
from repro_torch.tracing import span

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    cfg: ModelConfig
    optimizer: OptimizerConfig
    exchange: exch_lib.ExchangeConfig | None  # None -> plain mean-grad DP
    remat: bool = True
    exploit_window: bool = True
    seq_shard: bool = False  # the JAX package's mesh options: False on one card
    zero1: bool = False
    fsdp: bool = False


def value_and_grad(loss_fn, params: PyTree, batch: dict):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` in the parameters'
    dtypes. ``params`` need not require grad; they are not modified. A
    :class:`GradGraphs` loss replays its graph: the tensors returned are then
    the graph's, overwritten by its next replay."""
    with span("grads", timed=True):
        if isinstance(loss_fn, GradGraphs):
            return loss_fn.value_and_grad(params, batch)
        return _value_and_grad(loss_fn, params, batch)


def _value_and_grad(loss_fn, params: PyTree, batch: dict):
    leaves, unflatten = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(list(grads))


class GradGraphs:
    """A loss function whose value and gradient :func:`value_and_grad` takes
    as CUDA graphs, one per batch signature (names, shapes, dtypes).

    The first call of a signature captures it after PyTorch's recipe: two
    eager calls on a side stream set up autograd's, cuBLAS's and cuDNN's
    lazy state and the kernels' builds, then a third is captured on that
    stream. A call copies the batch into the graph's input buffers and
    replays it on the current stream. The graph reads the parameters where
    they lay at its capture, so they must be updated in place (as
    ``apply_update`` does); a call whose parameters lie elsewhere raises.
    Called directly it is the plain loss function (the monitored forward)."""

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn
        self.graphs: dict = {}

    def __call__(self, params: PyTree, batch: dict) -> torch.Tensor:
        return self.loss_fn(params, batch)

    def value_and_grad(self, params: PyTree, batch: dict):
        leaves, unflatten = tree_flatten(params)
        where = [p.data_ptr() for p in leaves]
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        if key not in self.graphs:
            self.graphs[key] = self._capture(params, batch, where)
        graph, inputs, loss, grads, at = self.graphs[key]
        if where != at:
            raise ValueError("the parameters moved since the gradient's graph was captured")
        for name, t in batch.items():
            inputs[name].copy_(t)
        graph.replay()
        return loss, unflatten(grads)

    def _capture(self, params: PyTree, batch: dict, where: list):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            inputs = {k: v.clone() for k, v in batch.items()}
            for _ in range(2):
                _value_and_grad(self.loss_fn, params, inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            loss, grads = _value_and_grad(self.loss_fn, params, inputs)
        torch.cuda.current_stream().wait_stream(side)
        return graph, inputs, loss, tree_flatten(grads)[0], where


def build_train_step(setup: TrainSetup, device: str | torch.device | None = None):
    """The step function of ``setup`` (see the module docstring); its inputs
    must lie on ``device`` (the card unless named)."""
    for name in ("seq_shard", "zero1", "fsdp"):
        if getattr(setup, name):
            raise NotImplementedError(
                f"TrainSetup.{name}=True needs the mesh, which is not ported yet "
                "(ROADMAP A7: launch/mesh); on one card set it False")
    dev = resolve_device(device)
    cfg, exch = setup.cfg, setup.exchange

    def loss_fn(params, batch):
        return train_loss(params, batch, cfg, remat=setup.remat,
                          exploit_window=setup.exploit_window)

    if dev.type == "cuda" and not cfg.copies_attn_scale:
        loss_fn = GradGraphs(loss_fn)

    def grad_fn(params, batch):
        return value_and_grad(loss_fn, params, batch)[1]

    def grouped(batch):
        G = exch.num_groups
        return {k: v.reshape(G, v.shape[0] // G, *v.shape[1:]) for k, v in batch.items()}

    def step(params, opt_state, exch_state, batch):
        for name, leaf in batch.items():
            if leaf.device != dev:
                raise ValueError(f"the batch's {name} lies on {leaf.device}, the step "
                                 f"runs on {dev}")
        with span("train.step", timed=True):
            metrics = {}
            if exch is None:
                loss, update = value_and_grad(loss_fn, params, batch)
            else:
                with torch.no_grad():
                    loss = loss_fn(params, batch)  # monitored value
                with span("exchange", timed=True):
                    update, exch_state, em = exch_lib.exchange_sequential(
                        exch, grad_fn, params, grouped(batch), exch_state, opt_state.step)
                metrics.update(em)
            with span("optimizer.update", timed=True):
                params, opt_state, om = apply_update(setup.optimizer, params, update,
                                                     opt_state)
            metrics.update(om)
            metrics["loss"] = loss
            return params, opt_state, exch_state, metrics

    return step
