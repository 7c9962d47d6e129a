"""Native runtime loader: builds (if needed) and binds libpfv_bitstream.so.

The serial entropy/bitstream layer lives in C++ (the reference implements it
in Rust: rle.rs, huffman.rs and the payload halves of enc.rs/dec.rs); this
module exposes it to Python via ctypes with numpy-array views. The library is
compiled on first import with the system toolchain and cached next to the
source under a name keyed to the source, compiler and host (_build_key).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "pfv_bitstream.cpp")
# -O2 measures equal-or-faster than -O3 on the branchy bit-twiddling hot
# loops here (-O3's extra vectorization does not apply and its code layout
# costs ~5-20% on the header parse). -march=native is safe because the
# build key below names the host.
_CXXFLAGS = ("-O2", "-march=native", "-fPIC", "-std=c++17", "-shared",
             "-pthread")

_lock = threading.Lock()
_lib = None


def _build_key(cxx: str) -> str:
    """Hash of everything the built library depends on: the source, the
    compiler and its flags, and the host it was built for. A library built
    anywhere else (another machine, another source) gets another name and
    is never loaded."""
    version = subprocess.run([cxx, "--version"], check=True,
                             capture_output=True).stdout
    h = hashlib.sha256()
    with open(_SRC_PATH, "rb") as f:
        h.update(f.read())
    for part in (cxx, " ".join(_CXXFLAGS), platform.machine(),
                 platform.node()):
        h.update(part.encode() + b"\0")
    h.update(version)
    return h.hexdigest()[:16]


def _so_path() -> str:
    """Path of the library for this source and host, built if missing.

    The build writes a private temporary file and renames it into place,
    so concurrent first imports (parallel test workers) never load a
    half-written library."""
    cxx = os.environ.get("CXX", "g++")
    path = os.path.join(_NATIVE_DIR,
                        f"libpfv_bitstream-{_build_key(cxx)}.so")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _SRC_PATH], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """Load (building if missing) the native bitstream library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_so_path())

        i64 = ctypes.c_int64
        p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

        lib.pfv_encode_iframe_payload.restype = i64
        lib.pfv_encode_iframe_payload.argtypes = [p_i16, i64, p_u8, p_u8, i64]

        lib.pfv_decode_iframe_payload.restype = i64
        lib.pfv_decode_iframe_payload.argtypes = [p_u8, i64, i64, p_i16, p_u8]

        lib.pfv_encode_iframe_payload_sparse.restype = i64
        lib.pfv_encode_iframe_payload_sparse.argtypes = [
            p_i32, p_i16, i64, i64, p_u8, p_u8, i64,
        ]

        lib.pfv_encode_pframe_payload_sparse.restype = i64
        lib.pfv_encode_pframe_payload_sparse.argtypes = [
            p_i32, p_i16, i64, p_i8, p_i8, p_u8, i64, p_u8, p_u8, i64,
        ]

        lib.pfv_encode_pframe_payload.restype = i64
        lib.pfv_encode_pframe_payload.argtypes = [
            p_i16, p_i8, p_i8, p_u8, i64, p_u8, p_u8, i64,
        ]

        lib.pfv_decode_pframe_payload.restype = i64
        lib.pfv_decode_pframe_payload.argtypes = [
            p_u8, i64, i64, p_i16, p_i8, p_i8, p_u8, p_u8,
        ]

        lib.pfv_parse_header.restype = i64
        lib.pfv_parse_header.argtypes = [p_u8, i64, p_i32, p_i32, i64]

        lib.pfv_ref_decode.restype = i64
        lib.pfv_ref_decode.argtypes = [
            p_u8, i64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64, p_i32,
        ]

        lib.pfv_count_frames.restype = i64
        lib.pfv_count_frames.argtypes = [p_u8, i64, i64]

        lib.pfv_demux_file.restype = i64
        lib.pfv_demux_file.argtypes = [
            p_u8, i64, i64, i64, i64,
            p_i16, p_i8, p_i8, p_u8, p_u8, p_u8, ctypes.c_int32,
        ]

        p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.pfv_demux_file_sparse.restype = i64
        lib.pfv_demux_file_sparse.argtypes = [
            p_u8, i64, i64, i64, i64,
            p_u16, ctypes.c_void_p, p_u8, p_u8,
            ctypes.c_void_p, ctypes.c_void_p, i64,
            ctypes.c_void_p, ctypes.c_int32,
        ]

        lib.pfv_unpack_block_headers.restype = None
        lib.pfv_unpack_block_headers.argtypes = [p_u16, i64, p_i8, p_i8, p_u8]

        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# numpy-friendly wrappers
# ---------------------------------------------------------------------------


def encode_iframe_payload(coeffs: np.ndarray, qidx: tuple[int, int, int]) -> bytes:
    """coeffs: (total_blocks, 256) int16 zigzag coefficients -> payload bytes."""
    lib = get_lib()
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int16)
    total_blocks = coeffs.shape[0]
    cap = coeffs.size * 4 + 1024
    qidx_arr = np.asarray(qidx, dtype=np.uint8)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pfv_encode_iframe_payload(
            coeffs.reshape(-1), total_blocks, qidx_arr, out, cap
        )
        if n >= 0:
            return out[:n].tobytes()
        if n != -1:
            raise ValueError(f"unencodable coefficients (code {n})")
        cap *= 2  # -1 = buffer too small (adversarially deep Huffman codes)


def decode_iframe_payload(
    payload: bytes, total_blocks: int
) -> tuple[np.ndarray, np.ndarray]:
    """payload -> ((total_blocks, 256) int16 coeffs, (3,) uint8 q-table idx)."""
    lib = get_lib()
    buf = np.frombuffer(payload, dtype=np.uint8)
    coeffs = np.empty(total_blocks * 256, dtype=np.int16)
    qidx = np.empty(3, dtype=np.uint8)
    rc = lib.pfv_decode_iframe_payload(
        buf, len(payload), total_blocks * 4, coeffs, qidx
    )
    if rc != 0:
        raise ValueError(f"corrupt I-frame payload (code {rc})")
    return coeffs.reshape(total_blocks, 256), qidx


def encode_iframe_payload_sparse(
    idx: np.ndarray,
    val: np.ndarray,
    total_blocks: int,
    qidx: tuple[int, int, int],
) -> bytes:
    """Sparse frame coefficients (sorted frame-local flat idx, nonzero
    val) -> I-frame payload bytes, byte-identical to the dense encoder —
    O(nonzeros) host work (no densify)."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.int16)
    nnz = idx.shape[0]
    cap = nnz * 8 + total_blocks * 48 + 1024
    qidx_arr = np.asarray(qidx, dtype=np.uint8)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pfv_encode_iframe_payload_sparse(
            idx, val, nnz, total_blocks, qidx_arr, out, cap
        )
        if n >= 0:
            return out[:n].tobytes()
        if n != -1:
            raise ValueError(f"unencodable coefficients (code {n})")
        cap *= 2


def encode_pframe_payload_sparse(
    idx: np.ndarray,
    val: np.ndarray,
    mvx: np.ndarray,
    mvy: np.ndarray,
    has_coeff: np.ndarray,
    qidx: tuple[int, int, int],
) -> bytes:
    """Sparse twin of encode_pframe_payload (entries in skipped blocks are
    ignored, like the dense encoder never reading them)."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.int16)
    nnz = idx.shape[0]
    total_blocks = mvx.shape[0]
    cap = nnz * 8 + total_blocks * 48 + 1024
    qidx_arr = np.asarray(qidx, dtype=np.uint8)
    mvx = np.ascontiguousarray(mvx, dtype=np.int8)
    mvy = np.ascontiguousarray(mvy, dtype=np.int8)
    hc = np.ascontiguousarray(has_coeff, dtype=np.uint8)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pfv_encode_pframe_payload_sparse(
            idx, val, nnz, mvx, mvy, hc, total_blocks, qidx_arr, out, cap
        )
        if n >= 0:
            return out[:n].tobytes()
        if n != -1:
            raise ValueError(f"unencodable coefficients (code {n})")
        cap *= 2


def encode_pframe_payload(
    coeffs: np.ndarray,
    mvx: np.ndarray,
    mvy: np.ndarray,
    has_coeff: np.ndarray,
    qidx: tuple[int, int, int],
) -> bytes:
    """Dense per-block arrays -> P-frame payload bytes."""
    lib = get_lib()
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int16)
    total_blocks = coeffs.shape[0]
    cap = coeffs.size * 4 + 16 * total_blocks + 1024
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pfv_encode_pframe_payload(
            coeffs.reshape(-1),
            np.ascontiguousarray(mvx, dtype=np.int8),
            np.ascontiguousarray(mvy, dtype=np.int8),
            np.ascontiguousarray(has_coeff, dtype=np.uint8),
            total_blocks,
            np.asarray(qidx, dtype=np.uint8),
            out,
            cap,
        )
        if n >= 0:
            return out[:n].tobytes()
        if n != -1:
            raise ValueError(f"unencodable coefficients (code {n})")
        cap *= 2  # -1 = buffer too small (adversarially deep Huffman codes)


def decode_pframe_payload(
    payload: bytes, total_blocks: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """payload -> (coeffs (N,256) i16, mvx (N,) i8, mvy (N,) i8,
    has_coeff (N,) u8, qidx (3,) u8)."""
    lib = get_lib()
    buf = np.frombuffer(payload, dtype=np.uint8)
    coeffs = np.empty(total_blocks * 256, dtype=np.int16)
    mvx = np.empty(total_blocks, dtype=np.int8)
    mvy = np.empty(total_blocks, dtype=np.int8)
    has_coeff = np.empty(total_blocks, dtype=np.uint8)
    qidx = np.empty(3, dtype=np.uint8)
    rc = lib.pfv_decode_pframe_payload(
        buf, len(payload), total_blocks, coeffs, mvx, mvy, has_coeff, qidx
    )
    if rc != 0:
        raise ValueError(f"corrupt P-frame payload (code {rc})")
    return coeffs.reshape(total_blocks, 256), mvx, mvy, has_coeff, qidx


def _mv_bounds(ly: tuple[int, int], lc: tuple[int, int]):
    """Per-block legal motion ranges for the concatenated Y,U,V block axis.

    Bounds are clipped into int8 so the validation comparisons run without
    upcasts: stream motion components are 7-bit (-64..63), so a bound
    outside that range can never be violated and clipping it to the range
    edge is equivalent.
    """
    key = (ly, lc)
    cached = _mv_bounds_cache.get(key)
    if cached is not None:
        return cached

    def plane(ph, pw):
        bw, bh = pw // 16, ph // 16
        b = np.arange(bh * bw)
        by, bx = (b // bw) * 16, (b % bw) * 16
        return -bx, pw - 16 - bx, -by, ph - 16 - by

    parts = [plane(*ly), plane(*lc), plane(*lc)]
    bounds = tuple(
        np.clip(np.concatenate([p[i] for p in parts]), -64, 63).astype(np.int8)
        for i in range(4)
    )
    _mv_bounds_cache[key] = bounds
    return bounds


_mv_bounds_cache: dict = {}


def validate_motion(mvx: np.ndarray, mvy: np.ndarray,
                    ly: tuple[int, int], lc: tuple[int, int]) -> None:
    """Reject motion vectors whose 16x16 prediction window leaves the padded
    plane. The reference panics on such streams (Rust slice indexing,
    common.rs); the JAX gather would silently clamp, so the host validates
    before upload. mvx/mvy: (..., B) int8 over the concatenated Y,U,V blocks.
    """
    lox, hix, loy, hiy = _mv_bounds(tuple(ly), tuple(lc))
    # all-int8 comparisons, short-circuited: legal streams exit on the
    # first test without touching the other three
    if (
        (mvx < lox).any() or (mvx > hix).any()
        or (mvy < loy).any() or (mvy > hiy).any()
    ):
        raise ValueError(
            "corrupt P-frame payload: motion vector out of bounds"
        )


def parse_header(data: bytes) -> tuple[dict, int]:
    """Parse a PFV header -> (info dict, first-packet byte offset)."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    dims = np.zeros(4, dtype=np.int32)
    # the format carries a u16 table count and the reference keeps them all
    # (dec.rs:96-111) — size the buffer from the stream, no arbitrary cap
    nq_guess = int.from_bytes(data[18:20], "little") if len(data) >= 20 else 0
    qtables = np.zeros(max(nq_guess, 1) * 64, dtype=np.int32)
    off = lib.pfv_parse_header(buf, len(data), dims, qtables, qtables.size)
    if off < 0:
        raise ValueError(f"bad PFV header (code {off})")
    nq = int(dims[3])
    info = {
        "width": int(dims[0]),
        "height": int(dims[1]),
        "framerate": int(dims[2]),
        "qtables": qtables[: nq * 64].reshape(nq, 64).copy(),
    }
    return info, int(off)


def demux_file(
    data: bytes, num_threads: int = 0
) -> tuple[dict, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Demux a whole .pfv file into dense per-frame tensors (threaded).

    Returns (info, coeffs (F, B, 256) i16, mvx (F, B) i8, mvy (F, B) i8,
    has_coeff (F, B) u8, ftype (F,) u8 [1=I, 2=P], qidx (F, 3) u8), where
    B = total macroblocks per frame (Y + U + V, padded). Drop frames and
    unknown packets are skipped (they emit no frame).
    """
    lib = get_lib()
    info, off = parse_header(data)
    w, h = info["width"], info["height"]

    def pad16(x):
        return x + (16 - x % 16) % 16

    yb = (pad16(h) // 16) * (pad16(w) // 16)
    cb = (pad16(h // 2) // 16) * (pad16(w // 2) // 16)
    total_blocks = yb + 2 * cb

    buf = np.frombuffer(data, dtype=np.uint8)
    nf = lib.pfv_count_frames(buf, len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    coeffs = np.empty((nf, total_blocks, 256), dtype=np.int16)
    mvx = np.empty((nf, total_blocks), dtype=np.int8)
    mvy = np.empty((nf, total_blocks), dtype=np.int8)
    has_coeff = np.empty((nf, total_blocks), dtype=np.uint8)
    ftype = np.empty(nf, dtype=np.uint8)
    qidx = np.empty((nf, 3), dtype=np.uint8)
    rc = lib.pfv_demux_file(
        buf, len(data), off, total_blocks, nf,
        coeffs.reshape(-1), mvx.reshape(-1), mvy.reshape(-1),
        has_coeff.reshape(-1), ftype, qidx.reshape(-1), num_threads,
    )
    if rc < 0:
        raise ValueError(f"demux failed (code {rc})")
    validate_motion(mvx, mvy, (pad16(h), pad16(w)),
                    (pad16(h // 2), pad16(w // 2)))
    info["yb"], info["cb"], info["total_blocks"] = yb, cb, total_blocks
    return info, coeffs, mvx, mvy, has_coeff, ftype, qidx


def _mv_bounds_packed(ly: tuple[int, int], lc: tuple[int, int]) -> np.ndarray:
    """Per-block packed int8 motion bounds (lox|hix<<8|loy<<16|hiy<<24) for
    the native validation in the sparse demux."""
    key = (ly, lc)
    cached = _mv_bounds_packed_cache.get(key)
    if cached is None:
        lox, hix, loy, hiy = (b.view(np.uint8).astype(np.uint32)
                              for b in _mv_bounds(ly, lc))
        cached = (lox | (hix << 8) | (loy << 16) | (hiy << 24)).view(np.int32)
        _mv_bounds_packed_cache[key] = cached
    return cached


_mv_bounds_packed_cache: dict = {}


_scratch_tls = threading.local()


def _scratch_buf(key: str, n: int, dtype) -> np.ndarray:
    """Reused scratch array (grow-only, per-thread): avoids the per-call
    mmap/page-fault churn of allocating the worst-case pairs bound (~70 MB
    at 1080p) fresh each demux (~0.6 ms/call). Thread-local so concurrent
    decodes (e.g. a VideoDataLoader prefetch thread next to a
    decode_video_rgb call) cannot corrupt each other's streams. Callers
    get a view; it is only valid until the next reuse_scratch call on the
    same thread — the dataloader uploads and drops it."""
    store = getattr(_scratch_tls, "bufs", None)
    if store is None:
        store = _scratch_tls.bufs = {}
    cur = store.get(key)
    if cur is None or cur.size < n or cur.dtype != np.dtype(dtype):
        cur = np.empty(max(n, int(1.2 * n)), dtype=dtype)
        store[key] = cur
    return cur


def demux_file_sparse_packed(data: bytes, num_threads: int = 0,
                             pad_to_multiple: int = 1,
                             reuse_scratch: bool = False):
    """Sparse whole-file demux, device-upload form.

    Returns (info, deltas (np,) u16, vals (np,) i8, bh (F, B) u16,
    ftype (F,) u8, qidx (F, 3) u8):
    - deltas chain the flat index (frame * B + block) * 256 + pos via an
      inclusive cumsum; the dense value at a position is the scatter-ADD
      of its units' vals (3 wire bytes per unit; |v| > 127 spans several
      same-position units; zero-value units — gap escapes, per-frame
      tails, bucket padding — are no-ops). The final unit parks the
      running position at F*B*256 (the sacrificial slot), so with
      pad_to_multiple > 1 the arrays are padded in place with zero units
      — no index computation, no extra host copies.
    - bh packs each block's header as (mvx & 127) | (mvy & 127) << 7 |
      has_coeff << 14 — uploadable as-is.
    F*B*256 must be < 2^31 (chunk longer videos). Motion vectors are
    bounds-validated natively (vectorized post-pass over the packed
    headers). With reuse_scratch=True the returned arrays are views into
    module-level scratch buffers, valid only until the next
    reuse_scratch call (the dataloader hot path: upload-then-drop).
    """
    lib = get_lib()
    info, off = parse_header(data)
    w, h = info["width"], info["height"]

    def pad16(x):
        return x + (16 - x % 16) % 16

    ly = (pad16(h), pad16(w))
    lc = (pad16(h // 2), pad16(w // 2))
    yb = (ly[0] // 16) * (ly[1] // 16)
    cb = (lc[0] // 16) * (lc[1] // 16)
    total_blocks = yb + 2 * cb

    buf = np.frombuffer(data, dtype=np.uint8)
    nf = lib.pfv_count_frames(buf, len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    span = total_blocks * 256
    if nf * span >= 2**31:
        raise ValueError("video too large for sparse flat indexing; chunk it")
    # worst-case units per payload byte is 69 (a 15-bit coefficient under a
    # degenerate zero-length-code tree costs 15 bits and spans 129 units),
    # also bounded by 129 units per coefficient slot, plus per-frame
    # escape/tail units; the native side additionally enforces per-frame
    # caps at emit time. The buffers are virtual — only the decoded prefix
    # is ever touched.
    # mirror the native per-frame bound exactly: min(69*plen + 8, ...) per
    # frame sums to at most min(69*len, 129*nf*span) + 8*nf across frames,
    # plus the gap-escape units and padding slack
    cap = (min(69 * len(data), 129 * nf * span) + nf * (span // 65535 + 1)
           + 8 * nf + 1024 + pad_to_multiple)
    if reuse_scratch:
        # scratch is thread-local (see _scratch_buf), so the native demux
        # below can write into it without a lock
        bh = _scratch_buf("bh", nf * total_blocks, np.uint16)[
            : nf * total_blocks
        ].reshape(nf, total_blocks)
        ftype = _scratch_buf("ftype", nf, np.uint8)[:nf]
        qidx = _scratch_buf("qidx", nf * 3, np.uint8)[: nf * 3].reshape(
            nf, 3
        )
        deltas = _scratch_buf("deltas", cap, np.uint16)
        vals = _scratch_buf("vals", cap, np.int8)
    else:
        bh = np.empty((nf, total_blocks), dtype=np.uint16)
        ftype = np.empty(nf, dtype=np.uint8)
        qidx = np.empty((nf, 3), dtype=np.uint8)
        deltas = np.empty(cap, dtype=np.uint16)
        vals = np.empty(cap, dtype=np.int8)
    bounds = _mv_bounds_packed(ly, lc)
    mv_absmax = np.zeros(1, dtype=np.int16)
    nunits = lib.pfv_demux_file_sparse(
        buf, len(data), off, total_blocks, nf,
        bh.reshape(-1), bounds.ctypes.data_as(ctypes.c_void_p),
        ftype, qidx.reshape(-1),
        deltas.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p),
        cap, mv_absmax.ctypes.data_as(ctypes.c_void_p), num_threads,
    )
    if nunits == -8:
        raise ValueError(
            "corrupt P-frame payload: motion vector out of bounds"
        )
    if nunits < 0:
        raise ValueError(f"sparse demux failed (code {nunits})")
    info["yb"], info["cb"], info["total_blocks"] = yb, cb, total_blocks
    info["mv_absmax"] = int(mv_absmax[0])
    m = pad_to_multiple
    padded = ((nunits + m - 1) // m) * m if m > 1 else nunits
    if padded > nunits:
        deltas[nunits:padded] = 0
        vals[nunits:padded] = 0
    return info, deltas[:padded], vals[:padded], bh, ftype, qidx


def unpack_block_headers(bh: np.ndarray):
    """Packed (.., B) u16 block headers -> (mvx i8, mvy i8, has_coeff u8)."""
    lib = get_lib()
    bh = np.ascontiguousarray(bh, dtype=np.uint16)
    mvx = np.empty(bh.shape, dtype=np.int8)
    mvy = np.empty(bh.shape, dtype=np.int8)
    hc = np.empty(bh.shape, dtype=np.uint8)
    lib.pfv_unpack_block_headers(
        bh.reshape(-1), bh.size, mvx.reshape(-1), mvy.reshape(-1),
        hc.reshape(-1),
    )
    return mvx, mvy, hc


def demux_file_sparse(data: bytes, num_threads: int = 0,
                      pad_to_multiple: int = 1):
    """Sparse whole-file demux, absolute-index three-array form.

    Returns (info, idx (nnzp,) i32, val (nnzp,) i16, mvx (F, B) i8,
    mvy (F, B) i8, has_coeff (F, B) u8, ftype (F,) u8, qidx (F, 3) u8),
    where idx holds strictly-increasing flat positions of the true
    nonzeros (zero-value bookkeeping units of the delta form are dropped —
    a stored 0 is a no-op in the pre-zeroed dense buffer; same-position
    repeat units of a |v| > 127 coefficient are summed back together).
    With pad_to_multiple > 1, padding indices point at the sacrificial
    slot F*B*256 with value 0. See demux_file_sparse_packed for the
    upload-optimal delta form this wraps.
    """
    info, deltas, vals, bh, ftype, qidx = demux_file_sparse_packed(
        data, num_threads
    )
    idx_all = np.cumsum(deltas, dtype=np.int64)
    if idx_all.size:
        # sum same-position repeat units (reduceat over run starts)
        first = np.empty(idx_all.shape, dtype=bool)
        first[0] = True
        np.not_equal(idx_all[1:], idx_all[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        idx_all = idx_all[starts]
        # NB reduceat promotes small ints to int64; the sum of one
        # position's repeat units is the original coefficient (|v| < 2^14),
        # so the cast back to i16 is exact.
        val_all = np.add.reduceat(vals, starts).astype(np.int16)
    else:
        val_all = np.zeros(0, dtype=np.int16)
    keep = val_all != 0
    idx = idx_all[keep].astype(np.int32)
    val = val_all[keep]
    nnz = idx.shape[0]
    m = pad_to_multiple
    padded = ((nnz + m - 1) // m) * m if m > 1 else nnz
    if padded > nnz:
        nf = ftype.shape[0]
        idx = np.concatenate([
            idx, np.full(padded - nnz, nf * info["total_blocks"] * 256,
                         dtype=np.int32),
        ])
        val = np.concatenate([val, np.zeros(padded - nnz, dtype=np.int16)])
    mvx, mvy, has_coeff = unpack_block_headers(bh)
    return info, idx, val, mvx, mvy, has_coeff, ftype, qidx


def ref_decode_into(
    data: bytes, y: np.ndarray, u: np.ndarray, v: np.ndarray
) -> int:
    """Scalar decode into preallocated per-frame buffers (benchmark form:
    mirrors the reference's reused retframe, dec.rs:195-199)."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    dims = np.zeros(4, dtype=np.int32)
    n = lib.pfv_ref_decode(
        buf, len(data),
        y.ctypes.data_as(ctypes.c_void_p),
        u.ctypes.data_as(ctypes.c_void_p),
        v.ctypes.data_as(ctypes.c_void_p),
        y.shape[0], dims,
    )
    if n < 0:
        raise ValueError(f"ref decode failed (code {n})")
    return int(n)


def ref_decode(
    data: bytes, emit: bool = True, max_frames: int = 1 << 30
) -> tuple[int, np.ndarray | None, np.ndarray | None, np.ndarray | None, dict]:
    """Scalar single-core decode of a whole .pfv buffer (baseline/oracle).

    Returns (num_frames, Y (F,h,w) u8 | None, U, V, info).
    """
    lib = get_lib()
    info, _ = parse_header(data)
    w, h = info["width"], info["height"]
    cw, ch = w // 2, h // 2
    buf = np.frombuffer(data, dtype=np.uint8)
    dims = np.zeros(4, dtype=np.int32)
    if emit:
        _, off = parse_header(data)
        exact = int(lib.pfv_count_frames(buf, len(data), off))
        if exact < 0:
            raise ValueError(f"corrupt packet stream (code {exact})")
        cap_frames = min(max_frames, exact)
        y = np.empty((cap_frames, h, w), dtype=np.uint8)
        u = np.empty((cap_frames, ch, cw), dtype=np.uint8)
        v = np.empty((cap_frames, ch, cw), dtype=np.uint8)
        n = lib.pfv_ref_decode(
            buf, len(data),
            y.ctypes.data_as(ctypes.c_void_p),
            u.ctypes.data_as(ctypes.c_void_p),
            v.ctypes.data_as(ctypes.c_void_p),
            cap_frames, dims,
        )
        if n < 0:
            raise ValueError(f"ref decode failed (code {n})")
        return int(n), y[:n], u[:n], v[:n], info
    n = lib.pfv_ref_decode(buf, len(data), None, None, None, 0, dims)
    if n < 0:
        raise ValueError(f"ref decode failed (code {n})")
    return int(n), None, None, None, info
