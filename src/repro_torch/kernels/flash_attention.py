"""Prefill attention with an online softmax: causal (with ``q_offset``),
sliding window, logit softcap, GQA (port of
``repro.kernels.flash_attention``).

The kernels are in ``csrc/flash_attention.cu``: bf16 runs on the tensor
cores (``flash_kernel_tc``: mma.sync, a cp.async K/V ring), fp32 on the
SIMT kernel (``flash_kernel``; tensor cores would round fp32 to TF32). The
dtype picks the kernel; any other dtype is refused.
:func:`flash_attention_ref` beside them is their plain PyTorch version (the
counterpart of ``repro.kernels.ref.flash_attention_ref``). The wrapper
serves a CPU tensor with the plain version and a CUDA tensor with a
kernel; there is no other route. Unlike the TPU wrapper, any ``sq`` and
``sk`` are taken: the kernels mask the ragged tail of their last tiles.

The kernels read q, k and v and write the output through their batch,
head and sequence strides, so the ``[b, s, h, hd]``-transposed views that
``attention_prefill`` passes need no copy; the output keeps q's strides
(``torch.empty_like``). A tensor whose head dim is not contiguous or
whose rows do not start on 16 bytes is copied to a contiguous one first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise TypeError("q must be [b, h, sq, hd] and k, v [b, kh, sk, hd]")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise TypeError(f"shapes do not fit: q {tuple(q.shape)}, "
                        f"k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")


def flash_attention_ref(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain version. q: [b, h, sq, hd]; k/v: [b, kh, sk, hd] ->
    [b, h, sq, hd] in q's dtype (fp32 math)."""
    _check(q, k, v)
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    g = h // k.shape[1]
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kr)
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window and window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides (head
    dim contiguous, every row starting on 16 bytes), else a contiguous
    copy."""
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, _ = t.shape
    step = 16 // t.element_size()  # elements in 16 bytes
    if (s3 == 1 and t.data_ptr() % 16 == 0 and (n0 == 1 or s0 % step == 0)
            and (n1 == 1 or s1 % step == 0) and (n2 == 1 or s2 % step == 0)):
        return t
    return t.contiguous()


_STRIDES = ctypes.c_longlong * 12


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """Contract of :func:`flash_attention_ref` (kernels on CUDA tensors:
    bf16 on tensor cores, fp32 SIMT; head dim in ``HEAD_DIMS``)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap,
                                   q_offset=q_offset)
    _build.require_cuda(q, "flash_attention")
    _check(q, k, v)
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES or hd not in HEAD_DIMS:
        raise TypeError(f"flash_attention takes fp32/bf16 and head dims "
                        f"{HEAD_DIMS}, not {q.dtype} / {hd}")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty_like(q)
    if sq == 0:
        return out
    strides = _STRIDES(*(q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                         + out.stride()[:3]))
    err = _build.lib("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh,
        sq, sk, hd, DTYPE_CODES[q.dtype], float(scale), int(bool(causal)),
        int(window), float(softcap), int(q_offset), strides,
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    return out
