"""K6: the phrase rows' additive contributions alone (the phrase delta).

The counterpart of experiments/phrase_delta_probe.py pallas_phrase_delta,
the TPU prototype that splits the mixed lane into the phrase stage alone
plus the keyword kernel (K1). For one batch of phrase rows:

    add_t[b, d] = sum of row b's valid phrase-term title weights where the
                  title holds every valid term and the positional chain
                  holds (mixed.py's semantics), else 0
    add_b[b, d] = the same for the body
    flag[b, d]  = 1 where either section matched (emit_flag)

so K1's keyword scores plus (add_t, add_b), with the flag as candidacy,
are what K2 computes for those rows.

`phrase_delta` is the wrapper: on CUDA tensors it launches the hand-written
kernels (csrc/phrase_delta.cu: a partition of the batch with its phrase
rows first, a probe table of the phrase entries per tile of phrase rows,
then K2's sweep and phrase stage, csrc/phrase.cuh, compiled for the
index's bucket of position planes, and zeros for the other rows) or
raises; on CPU tensors it runs mixed.plain_phrase_delta, the plain PyTorch
version (the phrase half of plain_mixed_scores), which is also the on-card
reference. The position planes are int16 (quantize_posT) or f32, as K2
takes them. `plain_phrase_rows`, `plane_bucket` and `tile_rows` are the
host-side plan (the CPU tests reach them).
"""

from __future__ import annotations

import ctypes

import torch

from . import probe
from .membership import _check, _int32
from .mixed import C_MAX, P_MAX, plain_phrase_delta

#: launches of the CUDA kernel since the last reset
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # title ftT, fwT, Tt
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # body ftT, fwT, Tb
    ctypes.c_int,  # D
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # title posT, Ct, int16?
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # body posT, Cb, int16?
    ctypes.c_int, ctypes.c_int,  # plane bucket, B
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ph_ids, ph_valid, P
    ctypes.c_void_p,  # partition scratch (row map, ph_ids, ph_valid, n_ph, pad column)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table scratch, rows per tile, entries per tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # add_t, add_b, flag
    ctypes.c_void_p,  # stream
]


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def library():
    """The built K6 library (compiled on first use)."""
    from ._build import load_library

    built = load_library("phrase_delta")
    fn = built.lib.ss_phrase_delta
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        rows = built.lib.ss_phrase_rows
        rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p]
        rows.restype = ctypes.c_int
    return built


#: plane counts the chain check is compiled for (csrc/phrase_delta.cu)
PLANE_BUCKETS = (4, 8, 16, 32)


def plane_bucket(c: int) -> int:
    """The smallest compiled plane count that holds c planes; raises past
    the largest (C_MAX)."""
    for bucket in PLANE_BUCKETS:
        if 1 <= c <= bucket:
            return bucket
    raise ValueError(f"C={c} outside the kernel's plane buckets {PLANE_BUCKETS}")


def tile_rows(b: int) -> int:
    """Phrase rows per tile: 16 for a batch of at most 16 rows, else 32
    (a tile's sums, table and log take ~33 KB at P=16: several blocks per
    SM, and the benchmark mix's 32 phrase rows of 128 fit one tile)."""
    return 16 if b <= 16 else 32


def plain_phrase_rows(ph_ids: torch.Tensor, ph_valid: torch.Tensor):
    """The batch's partition as csrc/phrase_delta.cu phrase_rows_kernel
    makes it -> (row_map int32 [B], ph_ids [B, P], ph_valid [B, P], n_ph):
    positions [0, n_ph) hold the rows whose slot 0 is valid (the phrase
    rows), in batch order, then the other rows in batch order, whose slots
    are all made invalid."""
    has = ph_valid[:, 0] > 0
    row_map = torch.cat((has.nonzero().flatten(), (~has).nonzero().flatten())).to(torch.int32)
    ids = ph_ids[row_map.long()]
    valid = torch.where(has[row_map.long()][:, None], ph_valid[row_map.long()], 0.0)
    return row_map, ids, valid, int(has.sum())


def cuda_phrase_rows(ph_ids: torch.Tensor, ph_valid: torch.Tensor):
    """The partition the kernel makes on the card (the same tuple as
    plain_phrase_rows)."""
    b, p = ph_ids.shape
    buf = torch.empty(b * (1 + 2 * p) + 1, dtype=torch.int32, device=ph_ids.device)
    with torch.cuda.device(ph_ids.device):
        err = library().lib.ss_phrase_rows(
            ph_ids.data_ptr(), ph_valid.data_ptr(), b, p, buf.data_ptr(),
            torch.cuda.current_stream(ph_ids.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"phrase-row partition launch failed (cudaError {err})")
    return (buf[:b], buf[b : b + b * p].view(b, p),
            buf[b + b * p : b + 2 * b * p].view(torch.float32).view(b, p),
            int(buf[-1]))


def pad_column(b: int, device) -> torch.Tensor:
    """The [b, 1] keyword column K6's table build reads (the kernel writes
    its own): all TERM_PAD, so its tables hold the phrase entries only
    (probe.cuda_tables / plain_tables with this column, sections=1, over
    plain_phrase_rows' arrays, are K6's tables)."""
    return torch.full((b, 1), probe.TERM_PAD, dtype=torch.int32, device=device)


def phrase_delta(
    title_ftT, title_fwT, body_ftT, body_fwT,  # [T, D] int32 / f32
    title_posT, body_posT,  # [C*T, D] int16 (quantize_posT) or f32
    ph_ids,  # int32 [B, P] (sentinel pad)
    ph_valid,  # f32 [B, P] 1/0
    pn,  # int32 [B] active phrase slots (0: no phrase)
    emit_flag: bool = False,
):
    """-> (add_t, add_b, flag | None), each f32 [B, D]. pn must count each
    row's valid slots (they come first); the kernel reads them from
    ph_valid: a row whose slot 0 is valid is a phrase row, and the other
    rows' outputs are zeros, stored without a sweep. CPU tensors take the
    plain version; CUDA tensors launch the kernels."""
    if ph_ids.device.type == "cpu":
        return plain_phrase_delta(
            title_ftT, title_fwT, body_ftT, body_fwT, title_posT, body_posT,
            ph_ids, ph_valid, pn, emit_flag=emit_flag,
        )
    if ph_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ph_ids.device}")
    dev = ph_ids.device
    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    b, p = ph_ids.shape
    for t, name, dt in (
        (title_ftT, "title_ftT", torch.int32), (title_fwT, "title_fwT", torch.float32),
        (body_ftT, "body_ftT", torch.int32), (body_fwT, "body_fwT", torch.float32),
        (ph_ids, "ph_ids", torch.int32), (ph_valid, "ph_valid", torch.float32),
        (title_posT, "title_posT", title_posT.dtype), (body_posT, "body_posT", body_posT.dtype),
    ):
        _check(t, name, dt, 2, dev)
    for pos, name, tsec in ((title_posT, "title_posT", tt), (body_posT, "body_posT", tb)):
        if pos.dtype not in (torch.int16, torch.float32):
            raise ValueError(f"{name}: int16 or float32 planes, got {pos.dtype}")
        if pos.shape[1] != d or pos.shape[0] % tsec or not 1 <= pos.shape[0] // tsec <= C_MAX:
            raise ValueError(f"{name} {tuple(pos.shape)} vs T={tsec}, D={d}")
    if title_fwT.shape != (tt, d) or body_fwT.shape != (tb, d) or body_ftT.shape[1] != d:
        raise ValueError("forward tiles disagree on [T, D]")
    if not 1 <= p <= P_MAX or ph_valid.shape != (b, p):
        raise ValueError(f"P={p} outside the kernel's limits")
    if max(tt, tb) > 0x7FFF:
        raise ValueError(f"T={max(tt, tb)} past the kernel's slot log (32767)")
    _int32(pn, "pn", b, dev)
    ct, cb = title_posT.shape[0] // tt, body_posT.shape[0] // tb
    bucket = plane_bucket(max(ct, cb))
    rows = tile_rows(b)
    n = rows * (1 + p)
    tables = probe.scratch(b, rows, n, dev, sections=1)
    part = torch.empty(b * (2 + 2 * p) + 1, dtype=torch.int32, device=dev)
    add_t = torch.empty((b, d), dtype=torch.float32, device=dev)
    add_b = torch.empty_like(add_t)
    flag = torch.empty_like(add_t) if emit_flag else None
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_phrase_delta(
            title_ftT.data_ptr(), title_fwT.data_ptr(), tt,
            body_ftT.data_ptr(), body_fwT.data_ptr(), tb, d,
            title_posT.data_ptr(), ct, int(title_posT.dtype == torch.int16),
            body_posT.data_ptr(), cb, int(body_posT.dtype == torch.int16), bucket,
            b, ph_ids.data_ptr(), ph_valid.data_ptr(), p,
            part.data_ptr(), tables.data_ptr(), rows, n,
            add_t.data_ptr(), add_b.data_ptr(), None if flag is None else flag.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"phrase-delta kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    return add_t, add_b, flag
