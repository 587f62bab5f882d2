"""The exchange's split around the threshold: CUDA kernel and plain version.

No TPU kernel is replaced: the JAX counterpart is the jnp split of
``repro.core.exchange.exchange_sequential``. For one leaf of one worker
group, around the threshold ``t`` of ``core/compress.py`` ``threshold_for_topk``:

* the residual add, in place: ``res += grad`` (float32), after which ``res``
  holds ``dw`` (:func:`exchange_apply_add_plain`, :func:`exchange_apply_add_cuda`);
* the split: ``keep = dense_step | (|dw| >= t)``, ``sent = keep ? dw : 0``,
  ``acc += p_g * sent``, ``res = p_g > 0 ? dw - sent : dw``, and the group's
  accounting ``sent_count += p_g * kept``, ``byte_count += p_g * bytes(kept)``
  with ``bytes(c) = c * entry + overhead`` by the dense or the sparse format
  (:func:`exchange_apply_split_plain`, :func:`exchange_apply_split_cuda`).
  Without a threshold (a leaf sent densely) every coordinate is kept and
  bytes are the dense ones.

The plain versions are ``exchange_sequential``'s former PyTorch sequence, op
for op, with the results written into ``res``, ``acc``, ``sent_count`` and
``byte_count``. The CUDA versions are the two launches of
``csrc/exchange_apply.cu``, which evaluate the same float32 operations with
torch's roundings and read ``t``, ``p_g`` and ``dense_step`` on the card, so
they equal the plain versions on the card bit for bit, non-finite values
included, provided ``acc`` holds no -0.0 (the exchange's accumulator starts
at +0 and never does).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "exchange_apply"
_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def exchange_apply_add_plain(res: torch.Tensor, grad: torch.Tensor) -> None:
    """``res += grad`` in float32, in place."""
    res.add_(grad.to(torch.float32))


def exchange_apply_split_plain(res, acc, pg, dense_step, thresh, sent_count, byte_count, *,
                               dense_bytes: tuple[int, int],
                               sparse_bytes: tuple[int, int]) -> None:
    """The split of ``dw`` (held in ``res``) in place; ``thresh`` None: all kept."""
    dw = res
    if thresh is None:
        sent = dw
        acc += pg * sent
        res.copy_(torch.where(pg > 0, dw - sent, dw))
        kept = dw.numel()
        nbytes = float(kept * dense_bytes[0] + dense_bytes[1])
    else:
        mask = torch.abs(dw) >= thresh
        sent = torch.where(mask, dw, torch.zeros_like(dw))
        sent = torch.where(dense_step, dw, sent)
        mask = torch.where(dense_step, True, mask)
        acc += pg * sent
        res.copy_(torch.where(pg > 0, dw - sent, dw))
        kept = torch.sum(mask)
        nbytes = torch.where(dense_step, kept * dense_bytes[0] + dense_bytes[1],
                             kept * sparse_bytes[0] + sparse_bytes[1]).to(torch.float32)
    sent_count.add_(pg * kept)
    byte_count.add_(pg * nbytes)


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.exchange_apply_add_launch.argtypes = [p, p, ll, i, p]
        lib.exchange_apply_add_launch.restype = i
        lib.exchange_apply_split_launch.argtypes = [p, p, ll, p, p, p, i, p, p, p,
                                                    ll, ll, ll, ll, p]
        lib.exchange_apply_split_launch.restype = i
        lib.exchange_apply_scratch_words.argtypes = []
        lib.exchange_apply_scratch_words.restype = i
        lib._typed = True
    return lib


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"exchange_apply: {what}")


def _check_leaf(name: str, t: torch.Tensor, dev: torch.device, numel: int) -> None:
    _need(t.device == dev, f"{name} is on {t.device}, res on {dev}")
    _need(t.is_contiguous(), f"{name} must be contiguous")
    _need(t.numel() == numel, f"{name} has {t.numel()} entries, res {numel}")


def _check_scalar(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype) -> None:
    _need(t.device == dev, f"{name} is on {t.device}, res on {dev}")
    _need(t.dim() == 0 and t.dtype == dtype, f"{name} must be a 0-dim {dtype} tensor, "
          f"got {t.dtype} {tuple(t.shape)}")


def _check_res(res: torch.Tensor) -> None:
    _need(res.is_cuda, f"need a CUDA tensor, got one on {res.device}")
    _need(res.dtype == torch.float32, f"res must be float32, got {res.dtype}")
    _need(res.is_contiguous(), "res must be contiguous")
    _need(1 <= res.numel() < 2**31, f"need 1 to 2**31 - 1 entries, got {res.numel()}")


def exchange_apply_add_cuda(res: torch.Tensor, grad: torch.Tensor) -> None:
    """Pass 1 on the card: one launch on the current stream, no host sync.

    ``res`` contiguous float32; ``grad`` contiguous float32, bfloat16 or
    float16 with as many entries, on the same device.
    """
    _check_res(res)
    _check_leaf("grad", grad, res.device, res.numel())
    _need(grad.dtype in _GRAD_DTYPES, f"grad must be float32, bfloat16 or float16, "
          f"got {grad.dtype}")
    lib = _lib()
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream(res.device).cuda_stream
        code = lib.exchange_apply_add_launch(res.data_ptr(), grad.data_ptr(), res.numel(),
                                             _GRAD_DTYPES[grad.dtype], stream)
    _build.check(lib, NAME, code, "exchange_apply_add launch")


def exchange_apply_split_cuda(res, acc, pg, dense_step, thresh, sent_count, byte_count, *,
                              dense_bytes: tuple[int, int],
                              sparse_bytes: tuple[int, int]) -> None:
    """Pass 2 on the card: one launch on the current stream, no host sync.

    ``res`` and ``acc`` contiguous float32 leaves of one size that do not
    overlap; ``pg``, ``thresh`` (or None), ``sent_count`` and ``byte_count``
    0-dim float32 and ``dense_step`` 0-dim bool, all on ``res``'s device. Its
    scratch comes from ``torch.zeros``.
    """
    _check_res(res)
    dev, n = res.device, res.numel()
    _check_leaf("acc", acc, dev, n)
    _need(acc.dtype == torch.float32, f"acc must be float32, got {acc.dtype}")
    a0, r0 = acc.data_ptr(), res.data_ptr()
    _need(a0 + 4 * n <= r0 or r0 + 4 * n <= a0, "acc overlaps res")
    for name, t in (("pg", pg), ("sent_count", sent_count), ("byte_count", byte_count)):
        _check_scalar(name, t, dev, torch.float32)
    _check_scalar("dense_step", dense_step, dev, torch.bool)
    if thresh is not None:
        _check_scalar("thresh", thresh, dev, torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        scratch = torch.zeros(int(lib.exchange_apply_scratch_words()), dtype=torch.int64,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.exchange_apply_split_launch(
            r0, a0, n, None if thresh is None else thresh.data_ptr(), pg.data_ptr(),
            dense_step.data_ptr(), int(thresh is None), scratch.data_ptr(),
            sent_count.data_ptr(), byte_count.data_ptr(), *dense_bytes, *sparse_bytes, stream)
    _build.check(lib, NAME, code, "exchange_apply_split launch")
