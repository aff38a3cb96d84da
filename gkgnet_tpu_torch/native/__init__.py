"""Host-side image ops of the data loader in C++ (counterpart:
``gkgnet_tpu/native``), bound with ``ctypes``.

``fastops.cpp`` is built with ``g++`` at first use into
``build/fastops-<hash>.so`` at the repository root, where the hash covers
the source and the flags; the library is compiled under a temporary name
and renamed into place, so concurrent first users (the loader's spawned
workers) never load a half-written file. A failed build raises: there is no
quiet numpy fallback. ``-ffp-contract=off`` keeps every result bitwise the
numpy plain version beside its wrapper (``*_reference``), which the tests
hold it to.

Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from gkgnet_tpu_torch.ops._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastops.cpp")
# no -march=native: build/ may be copied to another machine, and the hash
# does not cover the host's instruction set
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
CXX_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the build took in this process, 0.0 when the library was already
# built; None until the library is loaded
build_seconds: float | None = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "fo_normalize_u8": (_U8P, _I64, _F32P, _F32P, _F32P),
    "fo_collate_normalize": (ctypes.POINTER(_U8P), _I64, _I64, _F32P, _F32P,
                             _F32P),
    "fo_mix_chain": (ctypes.POINTER(_U8P), _I64, _I64, _F32P, _I32P, _I32P,
                     _U8P),
    "fo_color_jitter": (_U8P, _I64, _I32P, _F32P, _I64, _U8P),
}


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"fastops-{digest.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=CXX_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"fastops build failed: {' '.join(cmd)}: {e}") \
            from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"fastops build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The built library, building it first if its source or flags
    changed."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = _lib_path()
            t0 = time.perf_counter()
            if not os.path.exists(path):
                _compile(path)
            seconds = time.perf_counter() - t0
            loaded = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib, build_seconds = loaded, seconds
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _rgb_u8(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim < 1 or img.shape[-1] != 3:
        raise ValueError(f"{what}: expected uint8 (..., 3), got {img.dtype} "
                         f"{img.shape}")
    return img


def _vec3(v) -> np.ndarray:
    out = np.ascontiguousarray(v, dtype=np.float32).reshape(-1)
    if out.shape != (3,):
        raise ValueError(f"expected 3 values, got {out.shape}")
    return out


def normalize_u8(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 (..., 3) -> float32 ``(x - mean) * (1 / std)``."""
    img = _rgb_u8(img, "normalize_u8")
    mean, std = _vec3(mean), _vec3(std)
    out = np.empty(img.shape, np.float32)
    lib().fo_normalize_u8(_ptr(img, ctypes.c_uint8), img.size // 3,
                          _ptr(mean, ctypes.c_float),
                          _ptr(std, ctypes.c_float),
                          _ptr(out, ctypes.c_float))
    return out


def normalize_u8_reference(img: np.ndarray, mean, std) -> np.ndarray:
    return (img.astype(np.float32) - _vec3(mean)) \
        * (np.float32(1.0) / _vec3(std))


def collate_normalize(imgs: list[np.ndarray], mean, std) -> np.ndarray:
    """List of HWC uint8 images of one shape -> (B, H, W, 3) normalized
    float32."""
    imgs = [_rgb_u8(i, "collate_normalize") for i in imgs]
    if not imgs or any(i.shape != imgs[0].shape for i in imgs):
        raise ValueError("collate_normalize: needs images of one shape")
    mean, std = _vec3(mean), _vec3(std)
    out = np.empty((len(imgs),) + imgs[0].shape, np.float32)
    srcs = (_U8P * len(imgs))(*(_ptr(i, ctypes.c_uint8) for i in imgs))
    lib().fo_collate_normalize(srcs, len(imgs), imgs[0].size // 3,
                               _ptr(mean, ctypes.c_float),
                               _ptr(std, ctypes.c_float),
                               _ptr(out, ctypes.c_float))
    return out


def collate_normalize_reference(imgs: list[np.ndarray], mean, std
                                ) -> np.ndarray:
    return np.stack([normalize_u8_reference(i, mean, std) for i in imgs])


def mix_chain(views: list[np.ndarray], plan: list[tuple]) -> np.ndarray:
    """CropMixup's blend recursion over uint8 views (a 255-scale float32
    accumulator, a truncating clip to uint8). ``plan`` entries are
    ``(lam, perm_side, p0, p1, p2)`` with perm_side 0 = no permutation,
    1 = permute the incoming view, 2 = permute the accumulator."""
    views = [_rgb_u8(v, "mix_chain") for v in views]
    if not views or any(v.shape != views[0].shape for v in views) \
            or len(plan) != len(views) - 1:
        raise ValueError("mix_chain: needs views of one shape and "
                         "len(plan) == len(views) - 1")
    lams = np.array([lam for lam, *_ in plan], np.float32)
    sides = np.array([side for _, side, *_ in plan], np.int32)
    perms = np.array([p for *_, p0, p1, p2 in plan for p in (p0, p1, p2)],
                     np.int32)
    if np.any((sides < 0) | (sides > 2)) or np.any((perms < 0) | (perms > 2)):
        raise ValueError(f"mix_chain: bad plan {plan}")
    out = np.empty(views[0].shape, np.uint8)
    ptrs = (_U8P * len(views))(*(_ptr(v, ctypes.c_uint8) for v in views))
    lib().fo_mix_chain(ptrs, len(views), views[0].size,
                       _ptr(lams, ctypes.c_float), _ptr(sides, ctypes.c_int32),
                       _ptr(perms, ctypes.c_int32), _ptr(out, ctypes.c_uint8))
    return out


def mix_chain_reference(views: list[np.ndarray], plan: list[tuple]
                        ) -> np.ndarray:
    buf = views[0].astype(np.float32)
    for (lam, side, p0, p1, p2), v in zip(plan, views[1:]):
        lam = np.float32(lam)
        inv = np.float32(1.0) - lam
        perm = [p0, p1, p2]
        if side == 0:
            buf = lam * buf + inv * v.astype(np.float32)
        elif side == 1:
            buf = lam * buf + inv * v[..., perm].astype(np.float32)
        else:
            buf = lam * buf[..., perm] + inv * v.astype(np.float32)
    return np.clip(buf, 0, 255).astype(np.uint8)


def color_jitter(img: np.ndarray, ops: list[tuple]) -> np.ndarray:
    """Brightness/contrast/saturation chain over uint8 HWC RGB. ``ops`` =
    [(kind, factor)] with kind 0 = brightness, 1 = contrast, 2 =
    saturation; ITU-R 601 luma, clip after every op, round to nearest at the
    final store."""
    img = _rgb_u8(img, "color_jitter")
    kinds = np.array([k for k, _ in ops], np.int32)
    factors = np.array([f for _, f in ops], np.float32)
    if np.any((kinds < 0) | (kinds > 2)):
        raise ValueError(f"color_jitter: bad op kinds {kinds}")
    out = np.empty(img.shape, np.uint8)
    lib().fo_color_jitter(_ptr(img, ctypes.c_uint8), img.size,
                          _ptr(kinds, ctypes.c_int32),
                          _ptr(factors, ctypes.c_float), len(ops),
                          _ptr(out, ctypes.c_uint8))
    return out


def _luma(buf: np.ndarray) -> np.ndarray:
    return (np.float32(299.0) * buf[..., 0] + np.float32(587.0) * buf[..., 1]
            + np.float32(114.0) * buf[..., 2]) * np.float32(1e-3)


def color_jitter_reference(img: np.ndarray, ops: list[tuple]) -> np.ndarray:
    buf = img.astype(np.float32)
    for kind, factor in ops:
        factor = np.float32(factor)
        inv = np.float32(1.0) - factor
        if kind == 0:
            buf = np.clip(buf * factor, 0, 255)
        elif kind == 1:
            # the mean of the luma summed in double in pixel order
            # (cumsum adds one after another)
            total = np.cumsum(_luma(buf).reshape(-1).astype(np.float64))[-1]
            add = inv * np.float32(total / (buf.size // 3))
            buf = np.clip(factor * buf + add, 0, 255)
        else:
            add = inv * _luma(buf)
            buf = np.clip(factor * buf + add[..., None], 0, 255)
    return (np.clip(buf, 0, 255) + np.float32(0.5)).astype(np.uint8)
