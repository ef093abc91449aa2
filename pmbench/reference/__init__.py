"""Plain references of what the benchmark's cells run, and the precision they
are held at. Nothing here imports the program."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 products in full float32 (TF32 off), or in TF32 for the
    lower-precision control; the settings as they were after."""
    kept = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept
