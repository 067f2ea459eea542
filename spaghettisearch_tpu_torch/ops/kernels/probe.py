"""The probe tables K1-K4 read, and a PyTorch walk of those kernels.

K1 and K3 (csrc/membership.cu), K2 (csrc/mixed.cu) and K4 (csrc/fused.cu)
do not compare every slot of a doc with every query term. Per section and
per row tile, a small kernel (csrc/probe.cuh build_tables_kernel, launched
by each entry point) first builds one table of the distinct query terms,
sorted. K1 and K2 build a title and a body table; K3 one table for its one
section; K4 one table that both sections are swept against (it reads all Q
columns and has no hot split). Each entry is one (term, row) pair, int32
term + int32 payload:

    keyword entry: payload = row << 16 | multiplicity   (1 .. Q)
    phrase entry:  payload = row << 16 | PHRASE | p     (K2 only)

`row` is local to the row tile. Multiplicity counts a term's active
occurrences in the row, so a term twice in a row counts twice (the plain
versions' rule). A phrase entry names one valid phrase position p of its
row; a term at several positions of one row has one entry for each.
Entries sort by (term, payload); pads (term TERM_PAD, payload -1) come
last. Keyword columns at or past a row's active count (qn for the title,
qnb for the body under the hot split) never enter: those are sentinels.
Neither do negative ids nor TERM_PAD (int32 max, a column pad), so a table
holds only real entries.

`build_tables` is the plain version of that build, in torch ops: the CPU
tests reach it, and on the card the kernel's tables must equal it entry
for entry (`cuda_tables` vs `plain_tables`). Built with torch ops on the card, the
tables cost ~20 small launches of host time per call, more than the
sweep itself, so the wrappers launch the kernel.

The sweep stages a tile's table in shared memory, sets a bit per entry in
a hash filter, and probes each real slot of its doc once: the filter
rejects almost every slot with one shared-memory load; a slot that passes
is found by a sorted search, and only its entries touch the rows they
name.

`walk_sections` (K1, K2), `walk_section` (one section: K3) and
`walk_fused` (K4) run the same algorithm with torch ops, slot row by slot
row across the docs, so the CPU tests check the tables and the probe
against the plain versions and the JAX package. They are a model of the
kernels, not a fast path: the wrappers never call them.
"""

from __future__ import annotations

import torch

#: table pad: no slot holds it (slots are term ids >= 0 or the -1 pad)
TERM_PAD = 0x7FFFFFFF
#: a pad entry's sort key (term TERM_PAD, payload -1)
PAD_KEY = (TERM_PAD << 32) | 0xFFFFFFFF
#: payload flag of a phrase entry (csrc/probe.cuh kPhraseFlag)
PHRASE = 0x8000
#: rows of one row tile (csrc/probe.cuh kRowsMax)
ROWS_MAX = 64
#: the kernel's hash filter: 2**FILTER_BITS bits (csrc/probe.cuh)
FILTER_BITS = 15


def row_tile(b: int) -> int:
    """Rows per tile: the whole batch up to ROWS_MAX. The kernels put a
    doc block's row tiles next to each other in the grid, so the second
    tile of a B=128 batch finds the slots in L2."""
    return min(b, ROWS_MAX)


def build_tables(
    term_ids: torch.Tensor,  # int32 [B, Q]
    active: torch.Tensor,  # int32 [S, B]: section s reads columns < active[s, b]
    rows: int,  # row tile R
    ph_ids: torch.Tensor | None = None,  # int32 [B, P]
    ph_valid: torch.Tensor | None = None,  # f32 [B, P]
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (terms int32 [S, n_tiles, N], payload int32 [S, n_tiles, N]),
    N = R * (Q + P), each tile's entries sorted by (term, payload), pads
    last. Phrase entries (when given) are the same in every section."""
    b, q = term_ids.shape
    dev = term_ids.device
    s = active.shape[0]
    col = torch.arange(q, dtype=torch.int32, device=dev)
    valid = (col < active[:, :, None]) & (term_ids >= 0) & (term_ids != TERM_PAD)  # [S, B, Q]
    same = (term_ids[:, :, None] == term_ids[:, None, :]) & valid[:, :, None, :]
    mult = same.sum(-1, dtype=torch.int32)  # [S, B, Q]
    first = valid & ~same.tril(-1).any(-1)  # the row's first copy of the term
    local = (torch.arange(b, dtype=torch.int64, device=dev) % rows)[:, None] << 16
    key = torch.where(first, (term_ids.to(torch.int64) << 32) | local | mult, PAD_KEY)
    if ph_ids is not None:
        p = ph_ids.shape[1]
        keep = (ph_valid > 0) & (ph_ids >= 0) & (ph_ids != TERM_PAD)
        pos = local | PHRASE | torch.arange(p, dtype=torch.int64, device=dev)
        ph_key = torch.where(keep, (ph_ids.to(torch.int64) << 32) | pos, PAD_KEY)
        key = torch.cat((key, ph_key.expand(s, b, p)), dim=2)
    n_tiles = -(-b // rows)
    if n_tiles * rows != b:  # ragged last tile: pad rows enter no table
        pad = torch.full((s, n_tiles * rows - b, key.shape[2]), PAD_KEY, dtype=torch.int64, device=dev)
        key = torch.cat((key, pad), dim=1)
    key = key.reshape(s, n_tiles, -1).sort(dim=2).values
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def scratch(b: int, rows: int, n: int, device, sections: int = 2) -> torch.Tensor:
    """The int32 buffer an entry point builds its tables in: terms
    [S, n_tiles, n], payloads [S, n_tiles, n], then req [b] (csrc/probe.cuh
    Tables); S = 2 for K1/K2, 1 for K3/K4."""
    return torch.empty(2 * sections * -(-b // rows) * n + b, dtype=torch.int32, device=device)


def unpack(buf: torch.Tensor, b: int, rows: int, n: int, sections: int = 2):
    """(terms, payloads, req) views of a scratch() buffer."""
    m = sections * -(-b // rows) * n
    shape = (sections, -(-b // rows), n)
    return buf[:m].view(shape), buf[m : 2 * m].view(shape), buf[2 * m :]


def cuda_tables(term_ids, qn, qnb, ph_ids=None, ph_valid=None, sections: int = 2):
    """The tables as the entry points build them on the card (the kernel
    build_tables_kernel alone): K1's (or, with phrases, K2's) title and
    body tables, or with sections=1 K3's one table (columns < qn) or K4's
    (qn None: all columns) -> (terms, payloads, rows, req or None), to hold
    against plain_tables."""
    from . import membership

    b, q = term_ids.shape
    p = 0 if ph_ids is None else ph_ids.shape[1]
    rows = row_tile(b)
    n = rows * (q + p)
    buf = scratch(b, rows, n, term_ids.device, sections)
    lib = membership.library().lib
    with torch.cuda.device(term_ids.device):
        err = lib.ss_probe_tables(
            term_ids.data_ptr(), b, q, None if qn is None else qn.data_ptr(),
            None if qnb is None else qnb.data_ptr(),
            None if ph_ids is None else ph_ids.data_ptr(),
            None if ph_valid is None else ph_valid.data_ptr(), p, rows, n, sections,
            buf.data_ptr(), torch.cuda.current_stream(term_ids.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"table build launch failed (cudaError {err})")
    terms, pay, req = unpack(buf, b, rows, n, sections)
    return terms, pay, rows, (req if p else None)


def plain_tables(term_ids, qn, qnb, ph_ids=None, ph_valid=None, sections: int = 2):
    """The tables of a K1 call (or, with phrases, a K2 call), built as its
    entry point builds them but with build_tables: the title reads columns
    < qn (all Q when qn is None), the body columns < qnb (the cold terms
    under the hot split; qn without it). With sections=1 only the first:
    K3's table, or K4's with qn None. -> (terms, payloads, rows per tile,
    required phrase positions [B] or None), as cuda_tables returns them."""
    b, q = term_ids.shape
    if qn is None:
        qn = torch.full((b,), q, dtype=torch.int32, device=term_ids.device)
    body = qn if qnb is None else qnb
    active = torch.stack([qn.to(torch.int32), body.to(torch.int32)])[:sections]
    rows = row_tile(b)
    terms, pay = build_tables(term_ids, active, rows, ph_ids, ph_valid)
    return terms, pay, rows, (None if ph_ids is None else phrase_required(ph_valid))


def phrase_required(ph_valid: torch.Tensor) -> torch.Tensor:
    """int32 [B]: bit p set for each valid phrase position of the row; 0
    for a row whose position 0 is not valid (the row holds no phrase)."""
    p = ph_valid.shape[1]
    bits = (ph_valid > 0).to(torch.int32) << torch.arange(p, dtype=torch.int32, device=ph_valid.device)
    req = bits.sum(1, dtype=torch.int32)
    return torch.where((req & 1) == 1, req, 0)


# --------------------------------------------------------------------- #
# the kernels' algorithm, walked with torch ops (a model for the tests)
# --------------------------------------------------------------------- #


def filter_hash(f: torch.Tensor) -> torch.Tensor:
    """The kernel's filter index of term ids (csrc/probe.cuh filter_hash)."""
    return ((f.to(torch.int64) * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - FILTER_BITS)


def walk_section(
    ftT: torch.Tensor,  # int32 [T, D]
    fwT: torch.Tensor,  # f32 [T, D]
    terms: torch.Tensor,  # int32 [n_tiles, N] one section's tables
    pay: torch.Tensor,  # int32 [n_tiles, N]
    b: int,
    rows: int,
    n_phrase: int = 0,  # P: record phrase hits into slots [B, P, D]
    bound: torch.Tensor | None = None,  # int [D] slots past it are not read
):
    """One section's sweep: -> (score [B, D], count [B, D], slots) where
    slots[b, p, d] is the slot at which doc d holds row b's phrase term p
    (-1 when absent; None without phrases). Matches are added slot by slot,
    in slot order, as the kernel adds them."""
    t, d = ftT.shape
    n_tiles, n = terms.shape
    score = torch.zeros((n_tiles * rows, d), dtype=torch.float32)
    count = torch.zeros_like(score)
    slots = torch.full((n_tiles * rows, max(n_phrase, 1), d), -1, dtype=torch.int64)
    docs = torch.arange(d)
    for tile in range(n_tiles):
        tt, pp = terms[tile].to(torch.int64), pay[tile].to(torch.int64)
        real = tt != TERM_PAD
        filt = torch.zeros(1 << FILTER_BITS, dtype=torch.bool)
        filt[filter_hash(tt[real])] = True
        base = tile * rows
        for j in range(t):
            f = ftT[j].to(torch.int64)
            live = (f >= 0) & filt[filter_hash(f)]
            if bound is not None:
                live &= j < bound
            first = torch.searchsorted(tt, f)
            w = fwT[j]
            for k in range(n):
                e = first + k
                hit = live & (e < n)
                hit &= tt[e.clamp(max=n - 1)] == f
                if not bool(hit.any()):
                    break
                dd = docs[hit]
                pe = pp[e[hit]]
                row = base + (pe >> 16)
                kw = (pe & PHRASE) == 0
                m = (pe & 0x7FFF).to(torch.float32)
                score.index_put_((row[kw], dd[kw]), w[dd[kw]] * m[kw], accumulate=True)
                count.index_put_((row[kw], dd[kw]), m[kw], accumulate=True)
                if n_phrase:
                    ph = ~kw
                    slots[row[ph], (pe[ph] & 0x7FFF), dd[ph]] = j
    return score[:b], count[:b], (slots[:b] if n_phrase else None)


def chain_matches(
    slots: torch.Tensor,  # int64 [B, P, D] from walk_section
    req: torch.Tensor,  # int32 [B] phrase_required
    fwT: torch.Tensor,  # f32 [T, D]
    posT: torch.Tensor,  # f32 [C*T, D] (dequantized)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chain stage for one section -> (ok bool [B, D], summed
    phrase-term weights [B, D]). Only (row, doc) pairs whose sweep found
    every required term read positions; weights add in phrase order."""
    b, p, d = slots.shape
    t = fwT.shape[0]
    c = posT.shape[0] // t
    pos = posT.reshape(c, t, d)
    reqb = ((req[:, None].to(torch.int64) >> torch.arange(p)) & 1) == 1  # [B, P]
    complete = ((slots >= 0) | ~reqb[:, :, None]).all(1) & (req != 0)[:, None]
    ok = torch.zeros((b, d), dtype=torch.bool)
    sum_w = torch.zeros((b, d), dtype=torch.float32)
    docs = torch.arange(d)
    for row in range(b):
        dd = docs[complete[row]]
        if dd.numel() == 0:
            continue
        s = torch.zeros(dd.numel(), dtype=torch.float32)
        anchor = pos[:, slots[row, 0, dd], dd]  # [C, n]
        hit = anchor < 8388608.0  # POS_REAL_MAX
        for pi in range(p):
            if not bool(reqb[row, pi]):
                continue
            sl = slots[row, pi, dd]
            s = s + fwT[sl, dd]
            if pi == 0:
                continue
            cur = pos[:, sl, dd]  # [C, n]
            m = (cur[None, :, :] == anchor[:, None, :] + float(pi)).any(1)  # [C0, n]
            hit &= m
        ok[row, dd] = hit.any(0)
        sum_w[row, dd] = s
    return ok, sum_w


def walk_sections(
    title_ftT, title_fwT, body_ftT, body_fwT, terms, pay, b: int, rows: int,
    *, title_posT=None, body_posT=None, req=None, n_phrase: int = 0, body_bound=None,
):
    """K1 (no phrase arguments) or K2 walked with torch ops on CPU tensors
    -> (ts, tc, bs, bc), each [B, D]: the keyword sweep of both sections;
    with phrases, each section adds its summed phrase-term weights where
    the chain holds, and the title count gets one where either section
    matched."""
    ts, tc, tsl = walk_section(title_ftT, title_fwT, terms[0], pay[0], b, rows, n_phrase)
    bs, bc, bsl = walk_section(body_ftT, body_fwT, terms[1], pay[1], b, rows, n_phrase,
                               bound=body_bound)
    if n_phrase:
        t_ok, tw = chain_matches(tsl, req, title_fwT, title_posT)
        b_ok, bw = chain_matches(bsl, req, body_fwT, body_posT)
        ts = ts + torch.where(t_ok, tw, 0.0)
        bs = bs + torch.where(b_ok, bw, 0.0)
        tc = tc + (t_ok | b_ok).float()
    return ts, tc, bs, bc


def walk_fused(
    title_ftT, title_fwT, body_ftT, body_fwT,
    terms, pay,  # int32 [1, n_tiles, N]: the one shared table per row tile
    b: int, rows: int,
    mag_title, mag_body,  # f32 [D]
    pagerankT,  # f32 [C, D]
    query_len,  # f32 [B]
    topic_probs,  # f32 [B, C]
    weights,  # (w_pagerank, w_title, w_body, scale)
) -> torch.Tensor:
    """K4 walked with torch ops on CPU tensors -> final [B, D]: both
    sections swept against the one table, candidacy where some slot of
    either section matched the row (a zero weight included), then the
    kernel's finalize, one correctly rounded f32 operation at a time in its
    order (sqd summed over c in order)."""
    ts, tc, _ = walk_section(title_ftT, title_fwT, terms[0], pay[0], b, rows)
    bs, bc, _ = walk_section(body_ftT, body_fwT, terms[0], pay[0], b, rows)
    w_pr, w_title, w_body, scale = (torch.tensor(w, dtype=torch.float32) for w in weights)
    qmag = torch.sqrt(query_len)[:, None]

    def norm(s, mag):
        n = s / (mag[None, :] * qmag)
        return torch.where(torch.isnan(n), 0.0, n)

    sqd = torch.zeros_like(ts)
    for c in range(pagerankT.shape[0]):
        sqd = sqd + topic_probs[:, c, None] * pagerankT[c][None, :]
    final = (w_pr * sqd + w_title * norm(ts, mag_title) + w_body * norm(bs, mag_body)) * scale
    return torch.where((tc > 0) | (bc > 0), final, -float("inf"))
