"""SRA attention forward: wrapper, plain PyTorch version, launch count.

``sra_attention`` is SegFormer's spatial-reduction attention, the CUDA
kernel in ``csrc/sra_attention.cu``; that file's head says which TPU kernel
it replaces, what bounds it on an H100 and how it rounds.

It takes the JAX package's layout: q [B, N_q, H, D] and k, v [B, N_kv, H, D]
(``hiast_tpu/ops/pallas/attention.py:sra_attention``) and returns
[B, N_q, H, D] in q's dtype.  For tensors on the CPU it runs
``sra_attention_plain``; for CUDA tensors it launches the kernel or raises —
it never falls back.  The kernel has no backward (the TPU backward kernel is
still to port), so an input that requires grad is refused on either device:
autograd through the plain version would be a silent fallback.  Each launch
adds one to ``launch_counts['sra_attention']``; nothing else touches it.
"""
from __future__ import annotations

import ctypes

import torch

from hiast_tpu_torch.ops.cuda import build

HEAD_DIMS = (32, 64)  # the kernel's template instances; every MiT stage has D = 64 (B0: 32)
MAX_BATCH_HEADS = 65535  # grid.y

launch_counts = {"sra_attention": 0}

_VOID, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = [_VOID] * 4 + [_INT] * 5 + [_LL] * 8 + [ctypes.c_float, _VOID]
_bound: list = []


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernel():
    if not _bound:
        fn = build.load("sra_attention").sra_attention_fwd
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        _bound.append(fn)
    return _bound[0]


def sra_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The port of ``sra_attention_reference``: f32 scores from f32 products,
    softmax(S * D^-1/2) in f32, P cast to the input dtype, P V in f32 and a
    cast back.  Autocast is off inside, so the f32 products stay f32 (a
    caller on the card keeps TF32 off, as the entry points do)."""
    with torch.autocast(q.device.type, enabled=False):
        scale = 1.0 / q.shape[-1] ** 0.5
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        p = torch.softmax(s * scale, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, N, H, D]")
    b, n_q, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if n_q < 1 or k.shape[1] < 1:
        raise ValueError("q and k/v need at least one token")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of the kernel's {HEAD_DIMS}")
    if not (q.device == k.device == v.device) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k, v must lie on one CPU or CUDA device, got {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "sra_attention has no backward yet (the TPU backward kernel is not ported): "
            "call it under torch.no_grad() or torch.inference_mode()"
        )
    allowed = (torch.bfloat16,) if q.device.type == "cuda" else (torch.bfloat16, torch.float32)
    if q.dtype not in allowed:
        raise TypeError(f"sra_attention takes {allowed} on {q.device.type}, got {q.dtype}")
    if q.device.type == "cuda":
        if b * h > MAX_BATCH_HEADS:
            raise ValueError(f"batch * heads = {b * h} exceeds the kernel's grid")
        for name, x in (("q", q), ("k", k), ("v", v)):
            # the kernel reads rows of one head as 16-byte chunks in place
            if x.stride(3) != 1 or (h > 1 and x.stride(2) != d):
                raise ValueError(f"{name} must have contiguous heads ([..., H, D] with strides (D, 1))")
            if x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
                raise ValueError(f"{name} rows must be 16-byte aligned")
        cap = torch.cuda.get_device_capability(q.device)
        if cap != (9, 0):
            raise RuntimeError(f"the kernel is built for sm_90a; device has sm_{cap[0]}{cap[1]}")


def sra_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V per head: [B, N_q, H, D] in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return sra_attention_plain(q, k, v)
    b, n_q, h, d = q.shape
    out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n_q, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.stride(0), out.stride(1), 1.0 / d ** 0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"sra_attention launch failed with CUDA error {rc}")
    launch_counts["sra_attention"] += 1
    return out
