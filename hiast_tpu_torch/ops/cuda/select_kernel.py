"""IAS selection kernels: wrappers, plain PyTorch versions, launch counts.

``ias_hist`` (per-class confidence histogram) and ``ias_select``
(thresholded labels with per-sample counts and per-class confidence sums)
are CUDA kernels in ``csrc/select_kernel.cu``; that file's head says which
TPU kernel each replaces, what bounds it on an H100 and how it is built.

Each wrapper takes NCHW float32 logits [B, C, H, W] and a count ``nvalid``
of valid pixels in b-major order (the generator's pad samples are a suffix).
For a tensor on the CPU it runs the plain version beside it; for a CUDA
tensor it launches the kernel or raises — it never falls back (a refused
cluster launch raises too).  Each wrapper call that launches adds one to
``launch_counts[<kernel>]``, the small reduce launch that follows each
kernel included; nothing else touches the counts.  Two ``ias_select`` calls on the same
inputs give the same bits: its sums run in a fixed order.  ``ias_select``
returns its confidence sums in float64, unrounded (on the card the
kernel's exact fixed-point total), so that the sums of several ranks'
shares round once, where the caller rounds.
"""
from __future__ import annotations

import ctypes

import torch

from hiast_tpu_torch.ops.cuda import build
from hiast_tpu_torch.pseudo.policies import IGNORE, confidences

MAX_CLASSES = 32  # the kernels keep one pixel's logits in registers

launch_counts = {"ias_hist": 0, "ias_select": 0}

_VOID, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name: (argument types, result type)
_SIGNATURES = {
    "ias_hist_scratch": ([_VOID, _INT, _INT, _LL, _INT], _LL),
    "ias_hist": ([_VOID, _INT, _INT, _LL, _LL, _INT, _VOID, _VOID, _LL, _VOID], _INT),
    "ias_select_parts": ([_VOID, _INT, _INT, _LL], _LL),
    "ias_select": ([_VOID, _VOID, _INT, _INT, _LL, _LL, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _LL, _VOID],
                   _INT),
}
_bound: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def bind(lib: ctypes.CDLL) -> None:
    """Launch the kernels of ``lib`` from here on (a build of
    ``csrc/select_kernel.cu``, with other flags, say)."""
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        _bound[name] = fn


def _kernel(name: str):
    if not _bound:
        bind(build.load("select_kernel"))
    return _bound[name]


def _check_logits(logits: torch.Tensor) -> None:
    if logits.dim() != 4:
        raise ValueError(f"logits must be NCHW [B, C, H, W], got shape {tuple(logits.shape)}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"logits on unsupported device {logits.device}")
    if logits.device.type == "cuda":
        if logits.dtype != torch.float32:
            raise TypeError(f"the kernels read float32 logits, got {logits.dtype}")
        if not logits.is_contiguous():
            raise ValueError("the kernels read contiguous NCHW logits")
        if not 1 <= logits.shape[1] <= MAX_CLASSES:
            raise ValueError(f"the kernels take 1..{MAX_CLASSES} classes, got {logits.shape[1]}")
        if logits.shape[0] > 65535:
            raise ValueError(f"batch {logits.shape[0]} exceeds the kernels' grid")
        cap = torch.cuda.get_device_capability(logits.device)
        if cap != (9, 0):
            raise RuntimeError(f"the kernels are built for sm_90a; device has sm_{cap[0]}{cap[1]}")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    launch_counts[name] += 1


def _scratch_size(name: str, logits: torch.Tensor, *args) -> int:
    """The scratch a kernel needs for these logits (``ias_hist_scratch``:
    uint32 words; ``ias_select_parts``: rows of per-block partial sums)."""
    b, c, h, w = logits.shape
    with torch.cuda.device(logits.device):
        size = _kernel(name)(logits.data_ptr(), b, c, h * w, *args)
    if size < 1:
        raise RuntimeError(f"{name} failed with CUDA error {-size}")
    return size


# ---------------------------------------------------------------------------
# ias_hist
# ---------------------------------------------------------------------------
def ias_hist_plain(logits: torch.Tensor, nvalid: int, num_bins: int) -> torch.Tensor:
    """[C, num_bins] float32 counts of pixel confidences, by predicted class,
    over the first ``nvalid`` pixels; bin = clip(int(p * num_bins), 0, nb - 1)."""
    b, c = logits.shape[:2]
    maxprob, pred = confidences(logits.reshape(b, c, -1))
    maxprob = maxprob.reshape(-1)[: max(int(nvalid), 0)]
    pred = pred.reshape(-1)[: max(int(nvalid), 0)]
    bins = torch.clamp((maxprob * num_bins).to(torch.int64), 0, num_bins - 1)
    flat = torch.bincount(pred * num_bins + bins, minlength=c * num_bins)
    return flat.reshape(c, num_bins).float()


def ias_hist(logits: torch.Tensor, nvalid: int, num_bins: int) -> torch.Tensor:
    """Per-class confidence histogram [C, num_bins] float32 (counts)."""
    _check_logits(logits)
    if num_bins < 1:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    if logits.device.type == "cpu":
        return ias_hist_plain(logits, nvalid, num_bins)
    b, c, h, w = logits.shape
    hist = torch.empty((c, num_bins), dtype=torch.float32, device=logits.device)
    words = _scratch_size("ias_hist_scratch", logits, num_bins)
    scratch = torch.empty(words, dtype=torch.int32, device=logits.device)  # uint32 cluster histograms
    _launch("ias_hist", logits.device, logits.data_ptr(), b, c, h * w, int(nvalid),
            num_bins, hist.data_ptr(), scratch.data_ptr(), words)
    return hist


# ---------------------------------------------------------------------------
# ias_select
# ---------------------------------------------------------------------------
def ias_select_plain(logits: torch.Tensor, thresholds: torch.Tensor, nvalid: int, with_maxprob: bool = False):
    """(labels uint8 [B,H,W], counts int32 [B,C], sums float64 [C], maxprob).

    A pixel is selected when it is valid and its confidence reaches its
    class's threshold; its label is the class, else 255.  ``counts`` are the
    selected pixels per sample and class, ``sums`` their confidences per
    class; ``maxprob`` [B,H,W] is returned only ``with_maxprob``."""
    b, c, h, w = logits.shape
    maxprob, pred = confidences(logits)
    valid = torch.arange(b * h * w, device=logits.device).reshape(b, h, w) < int(nvalid)
    selected = valid & (maxprob >= thresholds.float()[pred])
    labels = torch.where(selected, pred, torch.full_like(pred, IGNORE)).to(torch.uint8)
    sample = torch.arange(b, device=logits.device).view(b, 1, 1).expand_as(pred)
    counts = torch.bincount((sample * c + pred)[selected], minlength=b * c)
    # summed in float64: a float32 sum over ~1e6 confidences a class drifts
    # by ~1e-3 relative, and these sums set HPA's hard classes next round
    sums = torch.zeros(c, dtype=torch.float64, device=logits.device)
    sums.index_add_(0, pred[selected], maxprob[selected].double())
    return (
        labels,
        counts.reshape(b, c).to(torch.int32),
        sums,
        maxprob if with_maxprob else None,
    )


def ias_select(logits: torch.Tensor, thresholds: torch.Tensor, nvalid: int, with_maxprob: bool = False):
    """Thresholded pseudo-label selection; see ``ias_select_plain``."""
    _check_logits(logits)
    b, c, h, w = logits.shape
    if tuple(thresholds.shape) != (c,):
        raise ValueError(f"thresholds must be [{c}], got {tuple(thresholds.shape)}")
    if logits.device.type == "cpu":
        return ias_select_plain(logits, thresholds, nvalid, with_maxprob)
    if thresholds.device != logits.device or thresholds.dtype != torch.float32:
        raise ValueError("thresholds must be float32 on the logits' device")
    thresholds = thresholds.contiguous()
    dev = logits.device
    labels = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    counts = torch.empty((b, c), dtype=torch.int32, device=dev)
    sums = torch.empty((c,), dtype=torch.float64, device=dev)
    maxprob = torch.empty((b, h, w), dtype=torch.float32, device=dev) if with_maxprob else None
    parts = _scratch_size("ias_select_parts", logits)
    part_cnt = torch.empty((parts, c), dtype=torch.int32, device=dev)
    part_sum = torch.empty((parts, c), dtype=torch.int64, device=dev)  # uint64 fixed point
    _launch("ias_select", dev, logits.data_ptr(), thresholds.data_ptr(), b, c, h * w,
            int(nvalid), labels.data_ptr(), maxprob.data_ptr() if with_maxprob else None,
            counts.data_ptr(), sums.data_ptr(), part_cnt.data_ptr(), part_sum.data_ptr(), parts)
    return labels, counts, sums, maxprob
