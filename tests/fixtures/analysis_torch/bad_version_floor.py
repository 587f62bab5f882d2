"""Seeded violations for the port's `version-floor` rule: spellings the
card's torch 2.11 lacks (the CPU tests' torch 2.13 has them)."""

import torch
import torch.nn.functional as F
from torch.nn.functional import linear_cross_entropy  # VIOLATION


def loss(h, w, y):
    a = F.linear_cross_entropy(h, w, y)  # VIOLATION
    b = linear_cross_entropy(h, w, y)  # reported at its import
    c = torch.nn.functional.cross_entropy(h @ w.T, y)  # fine: both have it
    return a + b + c


def pointer(t):
    return t.const_data_ptr()  # VIOLATION


def workspace():
    return torch.backends.cuda.cublas_workspace_size()  # VIOLATION
