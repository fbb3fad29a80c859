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

Head dim 4 (starcoder2-7b's SMOKE config) runs through the kernels at
head dim 8: :func:`padded` zero-pads q, k, v (and, in the backward, o and
dO) and slices the output and the gradients back, at the caller's
``scale`` (``PADDED_HEAD_DIMS``); a padded call reckons and counts as the
kernel's call at head dim 8.

The kernels read q, k and v and write the output through their batch,
head and sequence strides, so the ``[b, s, h, hd]``-transposed views that
``attention_prefill`` passes need no copy; the output keeps q's strides
(``torch.empty_like``). A tensor whose head dim is not contiguous or
whose rows do not start on 16 bytes is copied to a contiguous one first.

Training: on CUDA tensors :func:`flash_attention` goes through
:class:`FlashAttention`, an autograd function. Where a gradient is needed
its forward launches the kernel with the rows' log-sum-exp stored beside
the output, and its backward launches ``csrc/flash_attention_bwd.cu``
(three kernels: ``D = rowsum(dO o O)``, dK/dV summed over each GQA group,
dQ) through :func:`flash_attention_bwd`; elsewhere nothing more is stored
or launched. :func:`flash_attention_bwd_ref` is the backward's plain
version, by the same formulas in fp32. On CPU tensors the plain forward
is differentiated by autograd, as the reference differentiates its jnp.

On ``meta`` tensors (a dry run) every wrapper allocates what its CUDA
branch allocates and launches nothing (``_build``'s module docstring);
under an open cost counter CPU tensors take the kernels' route too, the
plain versions computing each call uncounted.
:func:`flash_cost` and :func:`flash_bwd_cost` are the kernels' work, one
count for the dry run's cost counter and ``chip_smoke.py``'s bounds.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
# head dims the wrappers take by zero-padding to a kernel's head dim (q, k,
# v and dO padded, the output and the gradients sliced back): exact, as
# the scale is explicit and zero columns add nothing to q.k or to P.V
PADDED_HEAD_DIMS = {4: 8}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_head_dim(hd: int) -> int:
    """The head dim the kernels run a call of head dim ``hd`` at."""
    return PADDED_HEAD_DIMS.get(hd, hd)


def takes_head_dim(hd: int) -> bool:
    """Whether the flash wrappers take head dim ``hd`` on the card."""
    return kernel_head_dim(hd) in HEAD_DIMS


def pad_head_dim(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``t`` [..., d] zero-padded to [..., hd] (itself where d == hd)."""
    d = t.shape[-1]
    return t if d == hd else torch.nn.functional.pad(t, (0, hd - d))


def padded(fn, q, k, v, *rest, **kw):
    """``fn(q, k, v, *rest, **kw)`` at the kernels' head dim: q, k, v (and
    every tensor of ``rest`` shaped like q: o, dO) zero-padded, and each
    tensor of the result shaped like a padded q (an output, a gradient)
    sliced back to q's head dim (an lse passes as it is). Autograd carries
    the pad and the slice, so a gradient through it is the kernel's at the
    padded dim, sliced."""
    hd = q.shape[-1]
    kd = kernel_head_dim(hd)
    if kd == hd:
        return fn(q, k, v, *rest, **kw)

    def fits(t, d):
        return (isinstance(t, torch.Tensor) and t.dim() == q.dim()
                and t.shape[-1] == d)
    rest = [pad_head_dim(t, kd) if fits(t, hd) else t for t in rest]
    out = fn(pad_head_dim(q, kd), pad_head_dim(k, kd), pad_head_dim(v, kd),
             *rest, **kw)
    if isinstance(out, tuple):
        return tuple(t[..., :hd] if fits(t, kd) else t for t in out)
    return out[..., :hd]


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


def _masks(sq, sk, causal, window, q_offset, device):
    """(visible [sq, sk], blind [sq]: rows that see no key) of the
    forward's mask."""
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window and window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
        blind = q_pos >= sk + window - 1
    else:
        blind = torch.zeros(sq, dtype=torch.bool, device=device)
    return mask, blind


def _capped_scores(q, k, *, scale, softcap):
    """fp32 (softcapped) scores [b, h, sq, sk] with k's heads repeated."""
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale,
                     k.repeat_interleave(g, dim=1).float())
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    return s


def attention_lse_ref(q, k, *, scale: float, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0) -> torch.Tensor:
    """The rows' log-sum-exp [b, h, sq] fp32 that the forward kernels store
    (natural log; -1e30 for a row that sees no key, where fp32 -1e30
    absorbs log sk)."""
    _check(q, k, k)
    mask, _ = _masks(q.shape[2], k.shape[2], causal, window, q_offset,
                     q.device)
    s = torch.where(mask, _capped_scores(q, k, scale=scale, softcap=softcap),
                    NEG_INF)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: float,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, q_offset: int = 0):
    """Plain version of the backward kernels: (dq, dk, dv) in fp32 from the
    forward's inputs, its output ``o`` and row log-sum-exp ``lse`` [b, h,
    sq] and the output's gradient ``do``, by the kernels' formulas: P =
    exp(s_c - lse), D = rowsum(do * o), dS = P (dP - D) (1 - (s_c /
    cap)^2) scale on visible pairs (0 elsewhere), dV = P^T dO and dK = dS^T
    Q summed over each kv head's query heads, dQ = dS K; a row that sees no
    key has P = 1 / sk over the keys and dS = 0."""
    _check(q, k, v)
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    g = h // kh
    mask, blind = _masks(sq, sk, causal, window, q_offset, q.device)
    sc = _capped_scores(q, k, scale=scale, softcap=softcap)
    vis = mask & ~blind[:, None]
    p = torch.where(vis, torch.exp(sc - lse.float()[..., None]), 0.0)
    p = torch.where(blind[:, None], 1.0 / sk, p)
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof,
                      v.repeat_interleave(g, dim=1).float())
    ds = torch.where(vis, p * (dp - delta[..., None]), 0.0)
    if softcap and softcap > 0:
        ds = ds * (1.0 - (sc / softcap) ** 2)
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds,
                      k.repeat_interleave(g, dim=1).float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    fold = lambda t: t.reshape(b, kh, g, sk, hd).sum(dim=2)  # noqa: E731
    return dq, fold(dk), fold(dv)


@functools.lru_cache(maxsize=None)
def visible_pairs(sq: int, sk: int, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> int:
    """(query, key) pairs of one (sequence, head) that the mask lets
    through: key ``j`` is visible to query row ``i`` (position ``q_offset
    + i``) where ``j <= q_offset + i`` (causal) and ``q_offset + i - j <
    window`` (window > 0)."""
    total = 0
    for i in range(sq):
        q = q_offset + i
        hi = min(sk, q + 1) if causal else sk
        lo = max(0, q - window + 1) if window and window > 0 else 0
        total += max(hi - lo, 0)
    return total


def flash_cost(b, h, kh, sq, sk, hd, elem, *, causal=True, window=0,
               q_offset=0, with_lse=False) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward call: q, k, v read once, the output
    (and the fp32 lse) written once; QK^T and PV over the visible pairs."""
    nbytes = (2 * b * h * sq * hd + 2 * b * kh * sk * hd) * elem
    if with_lse:
        nbytes += 4 * b * h * sq
    pairs = b * h * visible_pairs(sq, sk, causal, window, q_offset)
    return float(4 * pairs * hd), float(nbytes)


def flash_bwd_cost(kernel, b, h, kh, sq, sk, hd, elem, *, causal=True,
                   window=0, q_offset=0) -> tuple[float, float]:
    """(FLOPs, bytes) of one of the backward's three launches: ``delta``
    (o and dO read, D written: a multiply-add an element), ``dkdv`` (q, k,
    v, dO, lse and D read, dK and dV written; QK^T, dO V^T, P^T dO and
    dS^T Q over the visible pairs) and ``dq`` (the same reads, dQ written;
    QK^T, dO V^T and dS K)."""
    rows = b * h * sq
    if kernel == "flash_attention_bwd_delta":
        return float(2 * rows * hd), float(2 * rows * hd * elem + 4 * rows)
    pairs = b * h * visible_pairs(sq, sk, causal, window, q_offset)
    reads = (2 * rows * hd + 2 * b * kh * sk * hd) * elem + 8 * rows
    if kernel == "flash_attention_bwd_dkdv":
        return float(8 * pairs * hd), float(reads + 2 * b * kh * sk * hd
                                            * elem)
    if kernel == "flash_attention_bwd_dq":
        return float(6 * pairs * hd), float(reads + rows * hd * elem)
    raise ValueError(f"not a backward launch: {kernel}")


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


def _strides(*ts) -> ctypes.Array:
    """The batch, head and sequence element strides of each tensor."""
    out = []
    for t in ts:
        out += t.stride()[:3]
    return (ctypes.c_longlong * len(out))(*out)


def _forward(q, k, v, *, scale, causal, window, softcap, q_offset,
             with_lse: bool):
    """One launch of the forward kernel on kernel views of q, k, v:
    (out, lse [b, h, sq] fp32 or None)."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    name = "flash_attention_lse" if with_lse else "flash_attention"
    _build.reckon(name, *flash_cost(
        b, h, kh, sq, sk, hd, q.element_size(), causal=causal, window=window,
        q_offset=q_offset, with_lse=with_lse), q)
    if sq == 0 or _build.on_meta(q):
        return out, lse
    if q.device.type == "cpu":   # under a cost counter: the plain version
        with _build.uncounted():
            out.copy_(flash_attention_ref(
                q, k, v, scale=scale, causal=causal, window=window,
                softcap=softcap, q_offset=q_offset))
            if lse is not None:
                lse.copy_(attention_lse_ref(
                    q, k, scale=scale, causal=causal, window=window,
                    softcap=softcap, q_offset=q_offset))
        return out, lse
    err = _build.lib("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, kh, sq, sk, hd,
        DTYPE_CODES[q.dtype], float(scale), int(bool(causal)), int(window),
        float(softcap), int(q_offset), _strides(q, k, v, out),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    _build.count_launch(name)
    return out, lse


def _check_kernel_args(q, k, v):
    _build.require_cuda(q, "flash_attention", meta=True)
    _check(q, k, v)
    if q.dtype not in DTYPE_CODES or not takes_head_dim(q.shape[3]):
        raise TypeError(f"flash_attention takes fp32/bf16 and head dims "
                        f"{HEAD_DIMS} (and {tuple(PADDED_HEAD_DIMS)}, "
                        f"zero-padded), not {q.dtype} / {q.shape[3]}")


class FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernels for its gradient (CUDA
    tensors). q, k, v, the output and the row log-sum-exp are saved only
    when a gradient is needed; under ``torch.utils.checkpoint`` the
    recompute launches the forward again."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap, q_offset):
        grad = any(ctx.needs_input_grad[:3])
        q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
        out, lse = _forward(q, k, v, scale=scale, causal=causal,
                            window=window, softcap=softcap,
                            q_offset=q_offset, with_lse=grad)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.opts = dict(scale=scale, causal=causal, window=window,
                            softcap=softcap, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd_delta(o, do) -> torch.Tensor:
    """D = rowsum(do * o), [b, h, sq] fp32: the first of the backward's
    launches on CUDA tensors (the plain sum on the CPU)."""
    if o.device.type == "cpu" and not _build.counting():
        return (do.float() * o.float()).sum(dim=-1)
    _build.require_cuda(o, "flash_attention_bwd_delta", meta=True)
    if o.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd_delta takes fp32/bf16, not "
                        f"{o.dtype}")
    kd = kernel_head_dim(o.shape[3])   # zero columns add nothing to D
    o, do = pad_head_dim(o, kd), pad_head_dim(do, kd)
    b, h, sq, hd = o.shape
    o, do = _kernel_view(o), _kernel_view(do.to(o.dtype))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    _build.reckon("flash_attention_bwd_delta", *flash_bwd_cost(
        "flash_attention_bwd_delta", b, h, h, sq, sq, hd, o.element_size()),
        o)
    if sq == 0 or _build.on_meta(o):
        return delta
    if o.device.type == "cpu":   # under a cost counter: the plain sum
        with _build.uncounted():
            return delta.copy_((do.float() * o.float()).sum(dim=-1))
    err = _build.lib("flash_attention_bwd").flash_attention_bwd_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, h, sq, hd,
        DTYPE_CODES[o.dtype], _strides(o, do), _build.stream_ptr(o.device))
    _build.check(err, "flash_attention_bwd_delta")
    _build.count_launch("flash_attention_bwd_delta")
    return delta


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """(dq, dk, dv) in the input dtype and each input's layout, by the
    contract of :func:`flash_attention_bwd_ref` (kernels on CUDA tensors:
    three launches, fp32 sums; the plain version, rounded, on the CPU)."""
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if q.device.type == "cpu" and not _build.counting():
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    _check_kernel_args(q, k, v)
    if kernel_head_dim(q.shape[3]) != q.shape[3]:
        return padded(flash_attention_bwd, q, k, v, o, lse, do, **kw)
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    do = _kernel_view(do.to(q.dtype))
    o = _kernel_view(o)
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise TypeError("lse must be [b, h, sq] fp32")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = flash_attention_bwd_delta(o, do)
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        _build.reckon(name, *flash_bwd_cost(
            name, b, h, kh, sq, sk, hd, q.element_size(), causal=causal,
            window=window, q_offset=q_offset), q)
    if _build.on_meta(q):
        return dq, dk, dv
    if q.device.type == "cpu":   # under a cost counter: the plain version
        with _build.uncounted():
            for t, g in zip((dq, dk, dv),
                            flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                    **kw)):
                t.copy_(g)
        return dq, dk, dv
    lib = _build.lib("flash_attention_bwd")
    stream = _build.stream_ptr(q.device)
    code = DTYPE_CODES[q.dtype]
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    mask = (float(scale), int(bool(causal)), int(window), float(softcap),
            int(q_offset), strides, stream)
    err = lib.flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        kh, sq, sk, hd, code, *mask)
    _build.check(err, "flash_attention_bwd_dkdv")
    _build.count_launch("flash_attention_bwd_dkdv")
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, kh, sq, sk,
        hd, code, *mask)
    _build.check(err, "flash_attention_bwd_dq")
    _build.count_launch("flash_attention_bwd_dq")
    return dq, dk, dv


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """Contract of :func:`flash_attention_ref` (kernels on CUDA tensors:
    bf16 on tensor cores, fp32 SIMT; head dim in ``HEAD_DIMS``, or in
    ``PADDED_HEAD_DIMS`` through :func:`padded`; meta
    tensors: the allocations alone), with its gradient through
    :class:`FlashAttention`."""
    if q.device.type == "cpu" and not _build.counting():
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap,
                                   q_offset=q_offset)
    _check_kernel_args(q, k, v)
    return padded(FlashAttention.apply, q, k, v, scale, causal, window,
                  softcap, q_offset)
