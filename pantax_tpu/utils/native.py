"""On-demand build + ctypes loading of the native C++ data plane.

Compiles native/pantax_native.cpp into native/pantax_native.so (not tracked
by git) on first use in a checkout, and again whenever the source is newer,
and exposes typed wrappers.  Every entry point has a NumPy fallback so the
framework still runs where no compiler is available.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "pantax_native.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "pantax_native.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def load_native() -> ctypes.CDLL | None:
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = os.path.abspath(_SRC)
        so = os.path.abspath(_SO)
        if not os.path.exists(src):
            return None
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                # build beside the target and rename into place: processes
                # that build at once (test workers) never load a partial file
                tmp = f"{so}.{os.getpid()}.tmp"
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                        check=True, capture_output=True,
                    )
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            log.warning("native library unavailable, using NumPy paths: %s", e)
            return None
        lib.fastx_parse.restype = ctypes.c_longlong
        lib.fastx_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        lib.unique_kmer_positions.restype = ctypes.c_longlong
        lib.unique_kmer_positions.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.kmer_hash_sample.restype = ctypes.c_longlong
        lib.kmer_hash_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.pack_codes2_native.restype = ctypes.c_longlong
        lib.pack_codes2_native.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        lib.chd_build.restype = ctypes.c_longlong
        lib.chd_build.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def pack_codes2_native(codes: np.ndarray, lens: np.ndarray, cap: int):
    """Native 2-bit wire pack (aligner.pack_codes2 parity).

    Returns (packed uint8 [B, ceil(L/4)], exc int32 [cap]), None when the
    library is unavailable, or False when the batch exceeds ``cap``
    exceptions (caller falls back to the 4-bit pack)."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    B, L = codes.shape
    packed = np.empty((B, (L + 3) // 4), dtype=np.uint8)
    exc = np.empty(cap, dtype=np.int32)
    n = lib.pack_codes2_native(
        codes.ctypes.data_as(ctypes.c_void_p), B, L,
        lens.ctypes.data_as(ctypes.c_void_p),
        packed.ctypes.data_as(ctypes.c_void_p),
        exc.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n < 0:
        return False
    return packed, exc


def fastx_parse_native(data: bytes):
    """Parse a decompressed FASTA/FASTQ buffer.

    Returns (codes int8 [total_bases], offsets int64 [n+1], ids list[str])
    or None when the native library is unavailable / the format is unexpected.
    """
    lib = load_native()
    if lib is None:
        return None
    n_max = max(data.count(b"\n") // 2 + 2, 4)
    codes = np.empty(len(data), dtype=np.int8)
    offsets = np.empty(n_max + 1, dtype=np.int64)
    id_spans = np.empty(2 * n_max, dtype=np.int64)
    n = lib.fastx_parse(
        data, len(data),
        codes.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        id_spans.ctypes.data_as(ctypes.c_void_p),
        n_max,
    )
    if n < 0:
        return None
    ids = [
        data[id_spans[2 * i] : id_spans[2 * i + 1]].decode()
        for i in range(n)
    ]
    return codes[: offsets[n]], offsets[: n + 1], ids


def kmer_hash_sample_native(codes: np.ndarray, k: int, density_bits: int):
    """Single-pass sampled canonical k-mer hashing.

    Returns (hashes uint32 [m], positions int64 [m]) or None if unavailable.
    """
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    cap = max(n // max(1 << max(density_bits - 1, 0), 1) + 64, 64)
    while True:
        out_hash = np.empty(cap, dtype=np.uint32)
        out_pos = np.empty(cap, dtype=np.int64)
        m = lib.kmer_hash_sample(
            codes.ctypes.data_as(ctypes.c_void_p), n, k, density_bits,
            out_hash.ctypes.data_as(ctypes.c_void_p),
            out_pos.ctypes.data_as(ctypes.c_void_p), cap,
        )
        if m >= 0:
            return out_hash[:m].copy(), out_pos[:m].copy()
        cap = max(cap * 4, 1024)  # overflowed at -m entries; retry larger


def chd_build_native(keys: np.ndarray, mb: int, Tb: int):
    """Displacement-hash placement (align.aligner._build_chd's hot loop).

    Returns (slot int64 [n], disp int32 [2^mb]), None when the library is
    unavailable, or False when placement fails (caller falls back)."""
    lib = load_native()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = len(keys)
    slot = np.empty(n, dtype=np.int64)
    disp = np.empty(1 << mb, dtype=np.int32)
    rc = lib.chd_build(
        keys.ctypes.data_as(ctypes.c_void_p), n, mb, Tb,
        slot.ctypes.data_as(ctypes.c_void_p),
        disp.ctypes.data_as(ctypes.c_void_p),
    )
    if rc < 0:
        return False
    return slot, disp


def unique_kmer_positions_native(codes: np.ndarray, k: int):
    """(sorted 2-bit-packed keys uint64, positions int64) of k-mers occurring
    exactly once (N-containing k-mers skipped); None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    cap = max(n, 64)
    out_key = np.empty(cap, dtype=np.uint64)
    out_pos = np.empty(cap, dtype=np.int64)
    m = lib.unique_kmer_positions(
        codes.ctypes.data_as(ctypes.c_void_p), n, k,
        out_key.ctypes.data_as(ctypes.c_void_p),
        out_pos.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if m < 0:
        return None
    return out_key[:m].copy(), out_pos[:m].copy()
