"""SRA attention, forward and backward: wrappers, plain PyTorch versions,
launch counts.

``sra_attention`` is SegFormer's spatial-reduction attention, the CUDA
kernels in ``csrc/sra_attention.cu``; that file's head says which TPU
kernels they replace, what bounds them on an H100 and how they round.

It takes the JAX package's layout: q [B, N_q, H, D] and k, v [B, N_kv, H, D]
(``hiast_tpu/ops/pallas/attention.py:sra_attention``) and returns
[B, N_q, H, D] in q's dtype.  ``sra_attention_kv`` takes k and v as the two
halves of one fused projection kv [B, N_kv, 2 H D], as SegFormer computes
them, and its gradient is one d(kv) buffer written by the backward kernel:
autograd never zero-fills and copies a kv-shaped tensor per half.

Both are differentiable through one ``torch.autograd.Function``.  For tensors
on the CPU its forward and backward are ``sra_attention_plain`` and
``sra_attention_bwd_plain``; for CUDA tensors they launch the kernels or
raise -- they never fall back.  Without autograd (inference, or inputs that
need no grad) the forward launches with no residuals, as the serving path
always has.  Each forward launch adds one to
``launch_counts['sra_attention']``, each backward launch (the dQ kernel, the
dK/dV kernel and, where the query range is cut into chunks, the chunk
reduction) one to ``launch_counts['sra_attention_bwd']``; nothing else
touches them.
"""
from __future__ import annotations

import ctypes

import torch

from hiast_tpu_torch.ops.cuda import build

HEAD_DIMS = (32, 64)  # the kernel's template instances; every MiT stage has D = 64 (B0: 32)
MAX_BATCH_HEADS = 65535  # the largest B * H the kernels are held to
TILE = 64  # rows of one warpgroup's tile: K/V rows of a dK/dV warpgroup, query rows of a dK/dV stage
KV_BLOCK = 128  # K/V rows of one dK/dV work item (two warpgroups); each SM runs one item at a time
MAX_CHUNKS = 32  # the dK/dV kernel's query chunks, at most

launch_counts = {"sra_attention": 0, "sra_attention_bwd": 0}

_VOID, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sra_attention_fwd": [_VOID] * 6 + [_INT] * 5 + [_LL] * 8 + [ctypes.c_float, _VOID],
    "sra_attention_bwd": [_VOID] * 12 + [_INT] * 6 + [_LL] * 14 + [ctypes.c_float, _VOID],
}
_bound: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernel(name: str):
    if name not in _bound:
        fn = getattr(build.load("sra_attention"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return _bound[name]


def split_kv(kv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Views of the k and v halves of kv [B, N_kv, 2 H D] as [B, N_kv, H, D]."""
    b, n, two_c = kv.shape
    c = two_c // 2
    return kv[..., :c].reshape(b, n, heads, c // heads), kv[..., c:].reshape(b, n, heads, c // heads)


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


def sra_attention_kv_plain(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    return sra_attention_plain(q, *split_kv(kv, q.shape[2]))


def sra_attention_stats_plain(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward's residuals: per (b, h) row, the max m of the scaled f32
    scores and l = sum(exp(s - m)), each f32 [B * H, N_q]."""
    with torch.autocast(q.device.type, enabled=False):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
        m = s.amax(-1)
        lsum = torch.exp(s - m[..., None]).sum(-1)
    b, _, h, _ = q.shape
    return m.reshape(b * h, -1), lsum.reshape(b * h, -1)


def sra_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The port of ``_attn_bwd_kernel`` with its rounding points: P rebuilt
    in f32, P_lo = P cast to the input dtype for dV = P_lo^T dO, dP = dO V^T
    in f32, delta = rowsum(P * dP) with the f32 P, dS = P (dP - delta) scale
    cast to the input dtype before dQ = dS K and dK = dS^T Q, every product
    accumulated in f32 and each gradient cast to its input's dtype (the VJP
    casts dO to q's dtype first)."""
    lo = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        scale = 1.0 / q.shape[-1] ** 0.5
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        p = torch.softmax(s, dim=-1)
        dof = do.to(lo).float()
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(lo).float(), dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
        delta = (p * dp).sum(-1, keepdim=True)
        ds = (p * (dp - delta) * scale).to(lo).float()
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_layout(name: str, x: torch.Tensor, h: int, d: int) -> None:
    # the kernels read and write rows of one head as 16-byte chunks in place
    if x.stride(3) != 1 or (h > 1 and x.stride(2) != d):
        raise ValueError(f"{name} must have contiguous heads ([..., H, D] with strides (D, 1))")
    if x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name} rows must be 16-byte aligned")


def _fits(x: torch.Tensor, h: int, d: int) -> bool:
    try:
        _check_layout("", x, h, d)
    except ValueError:
        return False
    return True


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
    allowed = (torch.bfloat16,) if q.device.type == "cuda" else (torch.bfloat16, torch.float32)
    if q.dtype not in allowed:
        raise TypeError(f"sra_attention takes {allowed} on {q.device.type}, got {q.dtype}")
    if q.device.type == "cuda":
        if b * h > MAX_BATCH_HEADS:
            raise ValueError(f"batch * heads = {b * h} exceeds the kernel's grid")
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_layout(name, x, h, d)
        cap = torch.cuda.get_device_capability(q.device)
        if cap != (9, 0):
            raise RuntimeError(f"the kernel is built for sm_90a; device has sm_{cap[0]}{cap[1]}")


def _forward_cuda(q, k, v, with_stats: bool):
    """Launch the forward kernel; with ``with_stats`` it also writes the row
    statistics (m, l), f32 [B * H, N_q] each."""
    b, n_q, h, d = q.shape
    out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b * h, n_q), dtype=torch.float32, device=q.device) if with_stats else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel("sra_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            stats[0].data_ptr() if with_stats else None, stats[1].data_ptr() if with_stats else None,
            b, h, n_q, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.stride(0), out.stride(1), 1.0 / d ** 0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"sra_attention launch failed with CUDA error {rc}")
    launch_counts["sra_attention"] += 1
    return out, stats


def tiles_per_chunk(bh: int, n_q: int, n_kv: int, n_sms: int) -> int:
    """Query tiles (of ``TILE`` rows) per chunk of the dK/dV kernel.  Where
    the 64-row K/V tiles of all heads fill the card (at least one per SM),
    one chunk takes every query tile and the kernel writes dK and dV
    straight into d(kv).  Where they do not, the query range is cut into the
    number of chunks (at most ``MAX_CHUNKS``) whose work items, one per SM
    at a time, finish soonest: the fewest query tiles on the busiest SM,
    ties to fewer chunks (fewer f32 partials to add)."""
    q_tiles = -(-n_q // TILE)
    if bh * -(-n_kv // TILE) >= n_sms:
        return q_tiles
    blocks = bh * -(-n_kv // KV_BLOCK)
    best = None
    for want in range(1, min(q_tiles, MAX_CHUNKS) + 1):
        tpc = -(-q_tiles // want)
        rounds = -(-blocks * -(-q_tiles // tpc) // n_sms)
        cost = rounds * tpc
        if best is None or cost < best[0]:
            best = (cost, tpc)
    return best[1]


def _backward_cuda(q, k, v, out, stats, do, dk, dv) -> torch.Tensor:
    """Launch the backward kernels: returns dq, writes dk and dv (the halves
    of one d(kv) buffer, same strides)."""
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    props = torch.cuda.get_device_properties(q.device)
    tpc = tiles_per_chunk(b * h, n_q, n_kv, props.multi_processor_count)
    chunks = -(-(-(-n_q // TILE)) // tpc)
    dq = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
    rowstats = torch.empty((b * h, n_q, 4), dtype=torch.float32, device=q.device)
    partial = torch.empty((chunks, 2, b * h, n_kv, d), dtype=torch.float32, device=q.device) if chunks > 1 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel("sra_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), dq.data_ptr(), rowstats.data_ptr(),
            None if partial is None else partial.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n_q, n_kv, d, tpc,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.stride(0), out.stride(1), do.stride(0), do.stride(1), dq.stride(0), dq.stride(1),
            dk.stride(0), dk.stride(1), 1.0 / d ** 0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"sra_attention backward launch failed with CUDA error {rc}")
    launch_counts["sra_attention_bwd"] += 1
    return dq


class _SRAAttention(torch.autograd.Function):
    """softmax(Q K^T / sqrt(D)) V over q [B, N_q, H, D] and the fused
    kv [B, N_kv, 2 H D]; the gradient of kv is one buffer of its shape."""

    @staticmethod
    def forward(ctx, q, kv):
        k, v = split_kv(kv, q.shape[2])
        if q.device.type == "cpu":
            out = sra_attention_plain(q, k, v)
            ctx.save_for_backward(q, kv)
        else:
            out, stats = _forward_cuda(q, k, v, with_stats=True)
            ctx.save_for_backward(q, kv, out, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, kv, *residuals = ctx.saved_tensors
        h, d = q.shape[2], q.shape[3]
        k, v = split_kv(kv, h)
        dkv = torch.empty(kv.shape, dtype=kv.dtype, device=kv.device)
        dk, dv = split_kv(dkv, h)
        if q.device.type == "cpu":
            dq, dk_, dv_ = sra_attention_bwd_plain(q, k, v, do)
            dk.copy_(dk_)
            dv.copy_(dv_)
            return dq, dkv
        out, stats = residuals
        do = do.to(q.dtype)
        if not _fits(do, h, d):  # the kernels read dO rows in place; other layouts are copied
            do = do.contiguous()
        return _backward_cuda(q, k, v, out, stats, do, dk, dv), dkv


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def sra_attention_kv(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V per head with k, v the halves of kv
    [B, N_kv, 2 H D]: [B, N_q, H, D] in q's dtype."""
    if kv.dim() != 3 or kv.shape[-1] != 2 * q.shape[2] * q.shape[3]:
        raise ValueError(f"kv {tuple(kv.shape)} is not [B, N_kv, 2 H D] for q {tuple(q.shape)}")
    k, v = split_kv(kv, q.shape[2])
    _check(q, k, v)
    if _needs_grad(q, kv):
        return _SRAAttention.apply(q, kv)
    if q.device.type == "cpu":
        return sra_attention_plain(q, k, v)
    return _forward_cuda(q, k, v, with_stats=False)[0]


def sra_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V per head: [B, N_q, H, D] in q's dtype.
    Under autograd k and v are joined into one kv (their gradients come back
    as views of its gradient)."""
    _check(q, k, v)
    if _needs_grad(q, k, v):
        b, n_kv, h, d = k.shape
        kv = torch.cat([k.reshape(b, n_kv, h * d), v.reshape(b, n_kv, h * d)], dim=-1)
        return _SRAAttention.apply(q, kv)
    if q.device.type == "cpu":
        return sra_attention_plain(q, k, v)
    return _forward_cuda(q, k, v, with_stats=False)[0]
