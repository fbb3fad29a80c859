"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface (``extern "C"``
functions that take raw device pointers, ints and a stream and return the
launch's ``cudaGetLastError()``), so each one compiles with ``nvcc`` alone
in seconds into a shared library that ``ctypes`` loads; nothing includes
PyTorch's headers.

Builds happen at the first kernel call on a CUDA tensor (never at import:
the CPU tests import every module). All sources compile together, one
``nvcc`` process each, into ``build/repro_torch/<hash>/`` at the repository
root, where ``<hash>`` covers the sources and the flags, so an edited
kernel never loads a stale library. Only sources inside this package are
compiled.

``launches`` counts kernel launches per kernel name: each wrapper adds one
where it launches its kernel (``count_launch``) and nowhere else, so a run
can show that its main path went through the kernels (``reset_launches``
zeroes them). A wrapper called while a CUDA graph is being captured
launches nothing: under :func:`recording` its count goes to the capture's
record instead, and each replay of the graph adds the record
(``add_launches``), since each replay launches those kernels. A kernel
scratch that such a call uses is kept in the record too (``keep_alive``):
it must live as long as the graph that captured it.

**Meta tensors.** The model kernels' wrappers (flash attention and its
backward, paged attention, the Mamba2 scan and its backward) also take
``meta`` tensors, the device of a dry run (``launch/dryrun.py``): they
allocate on ``meta`` what their CUDA branch allocates (outputs and
scratch), launch nothing and count no launch. On CUDA and on meta alike
each call hands its work, (FLOPs, bytes: each input read once, each output
written once) by the kernel's own reckoning, to every open cost counter
(:func:`reckon`; ``roofline/cost.py`` opens one), so a walk on meta and
the same step on the card count the same.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("relscan", "hashidx", "flash_attention", "flash_attention_bwd",
           "paged_attention", "paged_attention_int8", "mamba_scan",
           "mamba_scan_bwd")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("relscan_scan", "relscan_compact", "hash_build", "hash_probe",
           "flash_attention", "paged_attention", "mamba2_scan",
           # training: the forward that also stores the rows' log-sum-exp,
           # and the three launches of its backward
           "flash_attention_lse", "flash_attention_bwd_delta",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
           # the Mamba2 scan's backward (three launches a call)
           "mamba2_scan_bwd",
           # the paged kernel's other two call forms, each launching
           # paged_wide_kernel: pages of 256 (the serving mesh's block) or
           # block starts, an output of q's dtype; and the striped form
           # with the rows' log-sum-exp (the serving mesh's island)
           "paged_attention_wide", "paged_attention_lse")
launches = {k: 0 for k in KERNELS}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}


_tls = threading.local()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` (into the capture's record while this
    thread captures a graph)."""
    rec = getattr(_tls, "rec", None)
    if rec is None:
        launches[name] += 1
    else:
        rec["launches"][name] = rec["launches"].get(name, 0) + 1


def keep_alive(t) -> None:
    """A scratch buffer this thread's capture uses (no-op otherwise)."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec["keep"].append(t)


@contextlib.contextmanager
def recording():
    """Record this thread's launches and scratch buffers (a capture)."""
    prev = getattr(_tls, "rec", None)
    rec = {"launches": {}, "keep": []}
    _tls.rec = rec
    try:
        yield rec
    finally:
        _tls.rec = prev


def add_launches(counts: dict) -> None:
    """The launches of one replay of a captured graph."""
    for k, n in counts.items():
        launches[k] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every source (in parallel) unless this hash is built, load
    the libraries, and return the ``-Xptxas -v`` report of each build
    (empty for a library that was already on disk)."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(ptxas_log)
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            so = out_dir / f"lib{name}.so"
            if so.exists():
                ptxas_log.setdefault(name, "")
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
        errors = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            ptxas_log[name] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in SOURCES:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            _declare(lib)
            _libs[name] = lib
        return dict(ptxas_log)


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported function: pointers and the
    stream as c_void_p (a bare Python int would be cut to 32 bits)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    PP = ctypes.POINTER(P)
    sigs = {
        "relscan_scan": [P, P, P, P, I, I, I, I, I, P, P, P, I, I, I, P, P,
                         P, P, P],
        "relscan_compact": [P, L, I, I, I, P, P, P, P, P],
        "hash_build": [P, P, I, I, I, P, P, P, P, P, P],
        "hash_build_scratch": [I, I, I],
        "hash_probe": [P, P, P, I, I, P, P, P],
        "hash_probe_verify": [P, P, P, P, I, I, P, P, PP, PP,
                              ctypes.POINTER(I), I, P, P, I, I, P, P, P, P,
                              P],
        "flash_attention": [P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, F,
                            I, ctypes.POINTER(L), P],
        "flash_attention_bwd_delta": [P, P, P, I, I, I, I, I,
                                      ctypes.POINTER(L), P],
        "flash_attention_bwd_dkdv": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                     I, I, F, I, I, F, I, ctypes.POINTER(L),
                                     P],
        "flash_attention_bwd_dq": [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                   F, I, I, F, I, ctypes.POINTER(L), P],
        "paged_attention": [P] * 12 + [I, I, I, I, I, I, I, I, I, F, F, I,
                                       P],
        "paged_attention_int8": [P] * 12 + [I, I, I, I, I, I, I, I, I, F, F,
                                            I, P],
        "paged_attention_scratch": [I, I, I, I, I],
        "paged_attention_form": [I, I, I],
        "mamba2_scan": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        "mamba2_scan_scratch": [I, I, I, I, I],
        "mamba2_scan_bwd": [P] * 15 + [I, I, I, I, I, I, P],
        "mamba2_scan_bwd_scratch": [I, I, I, I, I],
    }
    for fn, args in sigs.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = L if fn.endswith("_scratch") else I


def lib(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first
    use)."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: cudaError {err}")


def require_cuda(t, kernel: str, *, meta: bool = False) -> None:
    """A wrapper serves CPU tensors with its plain version and CUDA tensors
    with its kernel; where ``meta``, also meta tensors (the kernel's
    allocations, no launch) and, under an open cost counter, CPU tensors
    on the kernel's route (:func:`counting`); anything else is refused."""
    kind = t.device.type
    if kind != "cuda" and not (meta and (kind == "meta" or (
            kind == "cpu" and counting()))):
        raise RuntimeError(f"{kernel}: tensors on {t.device} are not served "
                           f"(CPU tensors take the plain version, CUDA "
                           f"tensors the kernel)")


def on_meta(t) -> bool:
    """Whether a wrapper's call is a dry run's (``meta`` tensors: allocate,
    reckon, launch nothing)."""
    return t.device.type == "meta"


# the open cost counters (roofline/cost.py); one process-wide list, since a
# card's backward runs on autograd's device thread
_counters: list = []
_quiet = threading.local()


def counting() -> bool:
    """Whether a cost counter is open. Under one, a model kernel's wrapper
    takes its kernel's route on CPU tensors too (its plain version
    computing inside :func:`uncounted`), so that a CPU step counts what the
    card's does."""
    return bool(_counters)


def counted() -> bool:
    """False inside :func:`uncounted` on this thread."""
    return not getattr(_quiet, "depth", 0)


@contextlib.contextmanager
def uncounted():
    """Work that a cost counter leaves out of its FLOPs and bytes: a
    collective's copies and sums, a plain version standing in for its
    kernel (whose reckoning counts it)."""
    _quiet.depth = getattr(_quiet, "depth", 0) + 1
    try:
        yield
    finally:
        _quiet.depth -= 1


def reckon(kernel: str, flops: float, nbytes: float, like) -> None:
    """Hand one kernel call's work to every open cost counter; ``like`` is
    a tensor of the call (its mesh coordinate is the call's)."""
    for c in _counters:
        c.kernel(kernel, flops, nbytes, like)


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer, without
    building a ``torch.cuda.Stream`` object (the call compiled PyTorch
    code makes)."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
