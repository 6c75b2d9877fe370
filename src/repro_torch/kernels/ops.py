"""Wrappers of the hand-written CUDA kernels: build, load, check, launch.

Each wrapper takes tensors on one device. On a CPU tensor it runs the
kernel's plain PyTorch version (in the kernel's own module). On a CUDA
tensor it launches the kernel on ``torch.cuda.current_stream()`` or
raises: there is no fallback from the card to the plain version.

The kernels are built at first use from ``csrc/*.cu`` with ``nvcc`` into
``build/repro_torch/`` at the root of the checkout (one ``nvcc`` process
per source, all started together) and loaded with ``ctypes``; a shared
library is named by the hash of its source and of every header the source
includes from ``csrc/``, so an edited source or header is rebuilt.
``launches`` counts, per kernel, the launches made through these wrappers,
and nothing else.

Both are safe from several threads (the serving scheduler launches from a
collate and a dispatch thread): one module lock covers the whole
check-build-load of ``build_kernels``, so each source is compiled once
however many threads reach first use together, and the launch counts are
updated under a lock of their own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import cost_matrix as _cm
from . import fused_phase as _fp
from . import sinkhorn_step as _ss
from . import slack_propose as _sp

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> (source in csrc/, C entry point, argtypes)
_ENTRY = {
    "slack_propose": ("slack_propose.cu", "slack_propose_launch",
                      [_P] * 8 + [_I] * 4 + [_P]),
    "cost_matrix": ("cost_matrix.cu", "cost_matrix_launch",
                    [_P] * 3 + [_I] * 6 + [_P]),
    "fused_assignment_phases": ("fused_assignment.cu",
                                "fused_assignment_launch",
                                [_P] * 19 + [_I] * 5 + [_P]),
    "fused_ot_phases": ("fused_ot.cu", "fused_ot_launch",
                        [_P] * 20 + [_I] * 6 + [_P]),
    "sinkhorn_row_update": ("sinkhorn_row.cu", "sinkhorn_row_launch",
                            [_P] * 7 + [_I] * 4 + [_P]),
}
# kernel name -> C function giving its workspace in bytes for (B, m, n)
_WORKSPACE = {
    "fused_assignment_phases": "fused_assignment_workspace",
    "fused_ot_phases": "fused_ot_workspace",
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_METRIC_ID = {"sqeuclidean": 0, "euclidean": 1, "l1": 2}

launches = {name: 0 for name in _ENTRY}
build_log: dict = {}
_libs: dict = {}
_workspace_fns: dict = {}
# guards the check-build-load of build_kernels (and _libs /
# _workspace_fns / build_log, which only it writes)
_build_lock = threading.Lock()
# guards launches
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("repro_torch: nvcc not found (CUDA_HOME, PATH, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def source_digest(src: Path) -> str:
    """Hash of ``src`` and of every header it includes from its directory,
    recursively, so an edit to a shared header rebuilds its users."""
    h = hashlib.sha256()
    todo, seen = [src], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        text = f.read_bytes()
        h.update(f.name.encode() + b"\0" + text)
        for inc in _INCLUDE.findall(text.decode()):
            dep = f.parent / inc
            if dep.is_file():
                todo.append(dep)
    return h.hexdigest()[:16]


def build_kernels() -> float:
    """Build (if needed) and load every kernel; returns the seconds spent.
    Raises if a source fails to compile or load. Thread-safe: callers that
    arrive while another thread builds wait for it and find the kernels
    loaded."""
    if len(_libs) == len(_ENTRY):     # published last, see _build_locked
        return 0.0
    with _build_lock:
        if len(_libs) == len(_ENTRY):
            return 0.0
        return _build_locked()


def _build_locked() -> float:
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name, (source, _, _) in _ENTRY.items():
        src = _CSRC / source
        todo[name] = (src, BUILD_DIR / f"lib{name}-{source_digest(src)}.so")
    nvcc = None
    procs = {}
    try:
        for name, (src, so) in todo.items():
            if so.exists():
                continue
            nvcc = nvcc or _nvcc()
            # unique per process and thread: another process may build
            # the same library into the same directory
            tmp = so.with_name(
                f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("repro_torch: nvcc failed for "
                               + "\n".join(failed))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    libs, ws_fns = {}, {}
    for name, (_, so) in todo.items():
        lib = ctypes.CDLL(str(so))
        _, fn_name, argtypes = _ENTRY[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = fn
        if name in _WORKSPACE:
            ws = getattr(lib, _WORKSPACE[name])
            ws.argtypes = [_I, _I, _I]
            ws.restype = ctypes.c_longlong
            ws_fns[name] = ws
    # the workspace functions first: a complete _libs is what the unlocked
    # check in build_kernels reads as "loaded"
    _workspace_fns.update(ws_fns)
    _libs.update(libs)
    return time.monotonic() - t0


def _workspace(name: str, b: int, m: int, n: int, device) -> torch.Tensor:
    """Scratch of the kernel ``name`` for a (b, m, n) batch, in bytes."""
    build_kernels()
    size = int(_workspace_fns[name](b, m, n))
    return torch.empty((size,), dtype=torch.uint8, device=device)


def _launch(name: str, *args) -> None:
    build_kernels()
    err = _libs[name](*args)
    if err != 0:
        raise RuntimeError(f"repro_torch: {name} kernel launch failed "
                           f"(cudaError {err})")
    with _count_lock:
        launches[name] += 1


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, "
                         f"got {t.device}")
    return True


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def slack_propose_batched(c_int, y_b, y_a, avail_a, salt, *, active_b=None):
    """Batched propose step: (B, m, n) int32 costs, (B, m) / (B, n) int32
    duals, (B, n) bool availability, (B,) int32 per-lane salt, optional
    (B, m) bool active rows. Returns ``(col (B, m) int32 (-1 = none),
    key (B, m) int64)``; see ``kernels/slack_propose.py``."""
    b, m, n = c_int.shape
    dev = c_int.device
    if active_b is None:
        active_b = torch.ones((b, m), dtype=torch.bool, device=dev)
    if not _on_cuda(c_int):
        return _sp.slack_propose_ref(c_int, y_b, y_a, avail_a, salt,
                                     active_b)
    _check("c_int", c_int, torch.int32, (b, m, n), dev)
    _check("y_b", y_b, torch.int32, (b, m), dev)
    _check("y_a", y_a, torch.int32, (b, n), dev)
    _check("avail_a", avail_a, torch.bool, (b, n), dev)
    _check("active_b", active_b, torch.bool, (b, m), dev)
    _check("salt", salt, torch.int32, (b,), dev)
    col = torch.empty((b, m), dtype=torch.int32, device=dev)
    key = torch.empty((b, m), dtype=torch.int64, device=dev)
    vec = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (c_int, y_a, avail_a)))
    _launch("slack_propose", c_int.data_ptr(), y_b.data_ptr(),
            y_a.data_ptr(), avail_a.data_ptr(), active_b.data_ptr(),
            salt.data_ptr(), col.data_ptr(), key.data_ptr(), b, m, n, vec,
            _stream(dev))
    return col, key


def slack_propose(c_int, y_b, y_a, avail_a, salt, *, active_b=None):
    """Unbatched form: (m, n), (m,), (n,), (n,), scalar salt -> (m,), (m,).
    The same kernel with B = 1."""
    dev = c_int.device
    salt_t = torch.as_tensor(salt, dtype=torch.int32, device=dev).reshape(1)
    col, key = slack_propose_batched(
        c_int[None], y_b[None], y_a[None], avail_a[None], salt_t,
        active_b=None if active_b is None else active_b[None])
    return col[0], key[0]


def cost_matrix_batched(x, y, metric: str = "sqeuclidean"):
    """(B, m, d) x (B, n, d) float32 -> (B, m, n) float32 in one launch.

    The kernel picks its instance from d: points (d <= 16, registers and
    streaming stores) or images (d > 16, shared-memory tiles filled by
    16-byte copies when d % 4 == 0 and x, y are 16-byte aligned, else by
    4-byte ones)."""
    if metric not in _METRIC_ID:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{tuple(_METRIC_ID)}")
    b, m, d = x.shape
    if y.shape[0] != b or y.shape[2] != d:
        raise ValueError(f"cost_matrix: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} disagree on batch or features")
    n = y.shape[1]
    if not _on_cuda(x):
        return _cm.cost_matrix_ref(x, y, metric)
    dev = x.device
    _check("x", x, torch.float32, (b, m, d), dev)
    _check("y", y, torch.float32, (b, n, d), dev)
    out = torch.empty((b, m, n), dtype=torch.float32, device=dev)
    aligned = int(d % 4 == 0 and x.data_ptr() % 16 == 0
                  and y.data_ptr() % 16 == 0)
    _launch("cost_matrix", x.data_ptr(), y.data_ptr(), out.data_ptr(), b, m,
            n, d, _METRIC_ID[metric], aligned, _stream(dev))
    return out


def cost_matrix(x, y, metric: str = "sqeuclidean"):
    """Unbatched form: (m, d) x (n, d) -> (m, n); the kernel with B = 1."""
    return cost_matrix_batched(x[None], y[None], metric)[0]


def fused_run_assignment_phases(c_int, state, threshold, phase_cap, k: int,
                                m_valid=None):
    """At most ``k`` assignment phases per lane in one launch: the fused
    counterpart of ``core.pushrelabel.run_assignment_phases``, with its
    signature. ``c_int`` (B, m, n) int32, ``state`` a
    ``PushRelabelState`` of (B, ...) int32 tensors, ``threshold`` /
    ``phase_cap`` / ``m_valid`` (B,) int32 (``m_valid`` None: every row).
    Returns a new state of the same type; ``state`` is not modified."""
    b, m, n = c_int.shape
    dev = c_int.device
    if m_valid is None:
        m_valid = torch.full((b,), m, dtype=torch.int32, device=dev)
    if not _on_cuda(c_int):
        return type(state)(*_fp.fused_assignment_phases_ref(
            c_int, *state, threshold, phase_cap, m_valid, k=k))
    _check("c_int", c_int, torch.int32, (b, m, n), dev)
    # the stepped cores may hand over views (match_ab is a slice)
    state = type(state)(*(t.contiguous() for t in state))
    for f, shape in zip(state._fields, [(b, m), (b, n), (b, m), (b, n),
                                        (b,), (b,), (b,)]):
        _check(f, getattr(state, f), torch.int32, shape, dev)
    for f, t in (("threshold", threshold), ("phase_cap", phase_cap),
                 ("m_valid", m_valid)):
        _check(f, t, torch.int32, (b,), dev)
    out = [torch.empty_like(t) for t in state]
    ws = _workspace("fused_assignment_phases", b, m, n, dev)
    vec = int(n % 4 == 0 and c_int.data_ptr() % 16 == 0)
    _launch("fused_assignment_phases", c_int.data_ptr(),
            *(t.data_ptr() for t in state), threshold.data_ptr(),
            phase_cap.data_ptr(), m_valid.data_ptr(),
            *(t.data_ptr() for t in out), ws.data_ptr(), b, m, n, int(k),
            vec, _stream(dev))
    return type(state)(*out)


def fused_run_ot_phases(c_int, state, threshold, phase_cap, k: int,
                        max_rounds: int):
    """At most ``k`` OT phases per lane in one launch: the fused
    counterpart of ``core.transport.run_ot_phases``, with its signature.
    ``c_int`` (B, nb, na) int32, ``state`` an ``OTState`` of (B, ...)
    int32 tensors, ``threshold`` / ``phase_cap`` (B,) int32. Returns a new
    state of the same type; ``state`` is not modified."""
    b, nb, na = c_int.shape
    dev = c_int.device
    if not _on_cuda(c_int):
        return type(state)(*_fp.fused_ot_phases_ref(
            c_int, *state, threshold, phase_cap, k=k,
            max_rounds=max_rounds))
    _check("c_int", c_int, torch.int32, (b, nb, na), dev)
    state = type(state)(*(t.contiguous() for t in state))
    for f, shape in zip(state._fields, [(b, nb), (b, na), (b, nb), (b, na),
                                        (b, nb, na), (b, nb, na), (b,),
                                        (b,)]):
        _check(f, getattr(state, f), torch.int32, shape, dev)
    for f, t in (("threshold", threshold), ("phase_cap", phase_cap)):
        _check(f, t, torch.int32, (b,), dev)
    out = [torch.empty_like(t) for t in state]
    ws = _workspace("fused_ot_phases", b, nb, na, dev)
    vec = int(na % 4 == 0 and c_int.data_ptr() % 16 == 0)
    _launch("fused_ot_phases", c_int.data_ptr(),
            *(t.data_ptr() for t in state), threshold.data_ptr(),
            phase_cap.data_ptr(), *(t.data_ptr() for t in out),
            ws.data_ptr(), b, nb, na, int(k), int(max_rounds), vec,
            _stream(dev))
    return type(state)(*out)


def sinkhorn_row_update(c, g, log_nu, reg, *, active_b=None, f=None):
    """Batched log-domain Sinkhorn f-update: ``c`` (B, m, n) f32, ``g``
    (B, n), ``log_nu`` (B, m), ``reg`` (B,) f32 -> (B, m) f32 with
    ``f[b, i] = reg[b] * (log_nu[b, i] - LSE_j((g[b, j] - c[b, i, j]) /
    reg[b]))``; see ``kernels/sinkhorn_step.py``. ``active_b`` (B,) bool
    marks the lanes to update; the others get ``f`` (B, m), their current
    potentials, back unchanged (so ``f`` is required with ``active_b``),
    and the kernel reads none of their costs."""
    b, m, n = c.shape
    if active_b is not None and f is None:
        raise ValueError("sinkhorn_row_update: active_b needs f, the "
                         "potentials the inactive lanes keep")
    if not _on_cuda(c):
        out = _ss.sinkhorn_row_ref(c, g, log_nu, reg)
        return out if active_b is None else torch.where(
            active_b[:, None], out, f)
    dev = c.device
    _check("c", c, torch.float32, (b, m, n), dev)
    _check("g", g, torch.float32, (b, n), dev)
    _check("log_nu", log_nu, torch.float32, (b, m), dev)
    _check("reg", reg, torch.float32, (b,), dev)
    if active_b is not None:
        _check("active_b", active_b, torch.bool, (b,), dev)
        _check("f", f, torch.float32, (b, m), dev)
    out = torch.empty((b, m), dtype=torch.float32, device=dev)
    vec = int(n % 4 == 0 and c.data_ptr() % 16 == 0
              and g.data_ptr() % 16 == 0)
    _launch("sinkhorn_row_update", c.data_ptr(), g.data_ptr(),
            log_nu.data_ptr(), reg.data_ptr(),
            0 if active_b is None else active_b.data_ptr(),
            0 if f is None else f.data_ptr(), out.data_ptr(), b, m, n, vec,
            _stream(dev))
    return out
