"""Build and load the CUDA kernels under ``csrc/`` and the host wire
codec under ``native/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  The host codec
(``native/wire_ingest.cpp``, plain C++ on a team of threads) is compiled the same
way by ``g++``.  Libraries land in ``build/crdt_tpu_torch/`` at the
repository root, named by a hash of their sources and flags: a build
happens at first use and is reused until a source changes.  Each build
writes a temporary file of its own process and renames it into place, so
several processes may build at once.  Only the sources in this package
are built; a missing compiler or a failed compile raises
:class:`KernelError`.

Each kernel also keeps a launch count here (:func:`launch_counts`), a
plain integer the wrappers add one to after every successful launch, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .error import KernelError

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "crdt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel name -> (source, {exported C function: argument types})
KERNELS = {
    "orswot_merge": ("orswot_merge.cu", {
        "orswot_merge_launch": [P] * 16 + [LL] + [I] * 7 + [P],
        "orswot_merge_plan": [P] * 8 + [I] * 6,
    }),
    "orswot_fold": ("orswot_fold.cu", {
        "orswot_fold_launch": [P] * 12 + [I, LL] + [I] * 6 + [P],
        "orswot_fold_acc_ints": [I, I, I],
        "orswot_fold_plan": [P] * 4 + [I] * 5,
    }),
    "orswot_fold_aligned": ("orswot_fold_aligned.cu", {
        "orswot_fold_aligned_launch": [P] * 11 + [I, LL] + [I] * 7 + [P],
        "orswot_fold_aligned_smem_per_warp": [I] * 7,
        "orswot_fold_aligned_plan": [P] * 4 + [I] * 5,
    }),
}
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")
_INGEST = [P, P] + [LL] * 4 + [P] * 6 + [LL, LL]
_ENCODE = [P] * 5 + [LL] * 4 + [P, P, LL]
# the codec legs: (name, argument types, suffixed by counter width)
_CODEC = (
    ("orswot_ingest_wire", _INGEST, True),
    ("orswot_encode_wire", _ENCODE, True),
    ("mvreg_ingest_wire", [P, P, LL, LL, LL, P, P, P, LL], True),
    ("mvreg_encode_wire", [P, P, LL, LL, LL, P, P, LL], True),
    ("clockish_ingest_wire", [P, P, LL, LL, LL, P, P, LL], True),
    ("clockish_encode_wire", [P, LL, LL, LL, P, P, LL], True),
    ("pncounter_ingest_wire", [P, P, LL, LL, P, P, LL], True),
    ("pncounter_encode_wire", [P, LL, LL, P, P, LL], True),
    ("gset_ingest_wire", [P, P, LL, LL, P, P, LL], False),
    ("gset_encode_wire", [P, LL, LL, P, P, LL], False),
    ("lww_ingest_wire_u64", [P, P, LL, P, P, P, LL], False),
    ("lww_encode_wire_u64", [P, P, LL, P, P, LL], False),
    # the Map legs: the map's 5 planes around its value planes (MVReg 2,
    # Orswot 5, Map<K2, MVReg> 7), sizes (A, K, D, then the value's)
    ("map_mvreg_ingest_wire", [P, P] + [LL] * 5 + [P] * 8 + [LL], True),
    ("map_mvreg_encode_wire", [P] * 7 + [LL] * 5 + [P, P, LL], True),
    ("map_orswot_ingest_wire", [P, P] + [LL] * 6 + [P] * 11 + [LL], True),
    ("map_orswot_encode_wire", [P] * 10 + [LL] * 6 + [P, P, LL], True),
    ("map_map_mvreg_ingest_wire", [P, P] + [LL] * 7 + [P] * 13 + [LL], True),
    ("map_map_mvreg_encode_wire", [P] * 12 + [LL] * 7 + [P, P, LL], True),
)
# host library name -> (source under native/, {exported C function: argument types})
HOST_LIBS = {
    "wire_ingest": ("wire_ingest.cpp", {
        name: argtypes
        for fn, argtypes, sized in _CODEC
        for name in ((f"{fn}_u32", f"{fn}_u64") if sized else (fn,))
    }),
}
# every codec ingest returns its count of flagged blobs; encodes return nothing
_RESTYPES = {
    "orswot_fold_acc_ints": LL,
    "orswot_fold_aligned_smem_per_warp": LL,
    **{fn: (LL if "_ingest_" in fn else None) for fn in HOST_LIBS["wire_ingest"][1]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()  # the wire loop's parse thread loads the codec too
#: the counts' one key that is not a kernel: pairwise merges that took the
#: plain wide path (member tables above 64 slots, which no kernel serves)
WIDE_MERGES = "orswot_merge_wide"
_LAUNCHES = {name: 0 for name in (*KERNELS, WIDE_MERGES)}
_LAUNCHES_LOCK = threading.Lock()  # two sync peers launch from two threads
#: build seconds and ptxas report of each library built by this process
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels "
        "are built from crdt_tpu_torch/csrc at first use"
    )


def _gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("g++")
    if found:
        return found
    raise KernelError(
        "g++ not found (set CXX or put g++ on PATH); the host wire codec is "
        "built from crdt_tpu_torch/native at first use"
    )


def _recipe(name: str):
    """``(compiler, flags, source, headers hashed with it, exports)`` of
    library ``name``."""
    if name in KERNELS:
        src, exports = KERNELS[name]
        return _nvcc, NVCC_FLAGS, CSRC / src, sorted(CSRC.glob("*.cuh")), exports
    src, exports = HOST_LIBS[name]
    return _gxx, GXX_FLAGS, NATIVE / src, [], exports


def _lib_path(name: str) -> Path:
    _, flags, src, headers, _ = _recipe(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for f in headers + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Build every library that is not built yet (by default every CUDA
    kernel and the host codec), one compiler per source, all started
    together.  Returns the seconds each build took (0.0 for a library
    already on disk)."""
    names = list([*KERNELS, *HOST_LIBS] if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiler, flags, src, _, _ = _recipe(name)
        cmd = [compiler(), *flags, "-o", str(tmp), str(src)]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        except OSError as e:
            for started, *_ in procs.values():
                started.kill()
                started.wait()
            raise KernelError(f"could not start the compiler for {name}: {e}") from e
        procs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = {"seconds": seconds[name], "ptxas": stderr}
        if proc.returncode != 0:
            failed.append(f"{name}: {cmd[0]} exited {proc.returncode}\n{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel of ``KERNELS`` or a host
    library of ``HOST_LIBS``), built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIBS_LOCK:
        if name not in _LIBS:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _recipe(name)[4].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = _RESTYPES.get(fn, I)
            if name in KERNELS:
                lib.orswot_error_string.argtypes = [I]
                lib.orswot_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


#: the kernel observatory timing launches while it is enabled
#: (:mod:`crdt_tpu_torch.obs.kernels`), else None
OBSERVER = None


def launch(name: str, fn: str, *args, nbytes: int | None = None) -> None:
    """Call launcher ``fn`` of kernel ``name`` on the current stream and
    count the launch; raise :class:`KernelError` if the launcher returns
    an error.  ``nbytes``, the bytes the kernel reads and writes, goes to
    the observatory with the launch's CUDA events."""
    lib = library(name)
    obs = OBSERVER
    start = obs.begin() if obs is not None else None
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.orswot_error_string(rc).decode(errors="replace")
        raise KernelError(f"{name} launch failed: CUDA error {rc} ({msg})")
    _count(name)
    if start is not None:
        obs.end(name, start, nbytes)


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """Successful launches of each kernel since the last reset, and the
    wide merges under :data:`WIDE_MERGES`."""
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
