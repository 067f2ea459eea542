"""The general traffic generator: a stream of query texts drawn from a seed.

A traffic mix (traffic/<name>.json) is data: a list of query classes with
their shares, and the df classes they draw words from. `Traffic` reads any
such file against a generated collection. Class kinds:

- "keywords": a list of df-class names, one keyword drawn uniformly from
  the words whose body df lies in each (luceneutil's Term and Or tasks);
- "phrase": {"words": n, "df": class}: a quoted run of n adjacent content
  tokens of a random document, kept when its rarest word's body df lies in
  the class (luceneutil's Phrase tasks);
- "question": {"base_words", "poisson_mean", "max_words", "stopword_share"}:
  base + Poisson(mean) words, capped, each a stopword with the given share
  and otherwise a content word drawn in proportion to its body df, with at
  least one content word (natural-language questions).

The stream is drawn a block of `BLOCK` queries at a time as a run takes
it, so its length follows the window and no rate is guessed ahead: by a
`Cursor` in the run's own process (one part of a block after each batch),
or, in the measured window, by a `Feed`'s child process, which keeps the
generator's work out of the window's host loop. The content seed (fixed
in the cell's file, like the shard's) and the block's index draw the
block's queries, so every run of a cell asks the same set; the run's seed
orders them within the block, and the shard's labels spell their words.
Every query's keyword and phrase ranks are kept beside its text, so the
harness's counts (the kernel bound) need no parse of their own.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import warnings
from dataclasses import dataclass

import numpy as np

from .collection import Collection

#: queries permuted among themselves by the run's seed
BLOCK = 1024
#: a block is drawn in PARTS parts, one at a time, so that no step of the
#: loop draws a whole block
PARTS = 4
#: blocks a Feed holds received ahead of the loop, and the seconds it
#: waits for one before it gives up
AHEAD, WAIT_S = 8, 60.0

_HERE = os.path.dirname(os.path.abspath(__file__))


def stopwords() -> list[str]:
    """The reference's stopwords that the build's parse drops (a data copy,
    data/stopwords.txt)."""
    with open(os.path.join(_HERE, "data", "stopwords.txt"), encoding="utf-8") as f:
        return [w for w in f.read().split() if w]


@dataclass
class Stream:
    """A stretch of the stream, in arrival order."""

    texts: list[str]
    cls: np.ndarray  # int16 class index per query
    class_names: list[str]
    kw: list[np.ndarray]  # keyword ranks per query (stopwords dropped)
    ph: list[np.ndarray]  # phrase ranks per query

    def __len__(self) -> int:
        return len(self.texts)


@dataclass
class Block:
    """One block's queries as numbers: each query's words as indices into
    `Traffic.spelling` (content ranks, then the stopwords), whether they
    are quoted, and its class, keyword and phrase ranks."""

    words: list[np.ndarray]
    quoted: np.ndarray
    cls: np.ndarray
    kw: list[np.ndarray]
    ph: list[np.ndarray]


def _df_class_words(df: np.ndarray, n_docs: int, bounds) -> np.ndarray:
    lo, hi = bounds
    share = df / float(n_docs)
    words = np.flatnonzero((df > 0) & (share >= lo) & ((share < hi) | (hi >= 1.0)))
    if words.size == 0:
        raise ValueError(f"no word's df share lies in {bounds} on {n_docs} docs")
    return words


def _in_class(share: np.ndarray, bounds) -> np.ndarray:
    lo, hi = bounds
    return (share >= lo) & ((share < hi) | (hi >= 1.0))


class Traffic:
    """The mix's stream against the collection, block by block: drawn from
    `content_seed` (the run's seed when None), ordered by `seed`. What every
    block reads (the df classes' words, the df-weighted draw, the words'
    spelling) is worked out once, here."""

    def __init__(self, mix: dict, coll: Collection, seed: int,
                 content_seed: int | None = None):
        self.coll, self.seed = coll, int(seed)
        self.content_seed = int(seed if content_seed is None else content_seed)
        self.classes = mix["classes"]
        self.class_names = [c["name"] for c in self.classes]
        share = np.array([c["share"] for c in self.classes], np.float64)
        self.p = share / share.sum()
        self.bounds = mix.get("df_classes", {})
        self.class_words = {k: _df_class_words(coll.body.df, coll.n_docs, b)
                            for k, b in self.bounds.items()}
        stop = stopwords()
        self.n_stop = len(stop)
        #: content words by rank, then the stopwords
        self.spelling = np.array(coll.words() + stop, dtype=object)
        self.lengths = (coll.body.tok >= 0).sum(axis=1)
        self.df_cdf = np.cumsum(coll.body.df.astype(np.float64))

    def text(self, words: np.ndarray, quoted: bool) -> str:
        t = " ".join(self.spelling[words].tolist())
        return '"' + t + '"' if quoted else t

    def block(self, i: int, parts: list[Block] | None = None) -> Block:
        """The i-th block of BLOCK queries, in arrival order: its PARTS
        parts (drawn here where not given), permuted by the run's seed."""
        parts = parts if parts is not None else [self.part(i, k) for k in range(PARTS)]
        words = [w for p in parts for w in p.words]
        kw = [w for p in parts for w in p.kw]
        ph = [w for p in parts for w in p.ph]
        quoted = np.concatenate([p.quoted for p in parts])
        cls = np.concatenate([p.cls for p in parts])
        perm = np.random.default_rng([self.seed, 0x52, int(i)]).permutation(len(words))
        return Block(words=[words[j] for j in perm], quoted=quoted[perm], cls=cls[perm],
                     kw=[kw[j] for j in perm], ph=[ph[j] for j in perm])

    def part(self, i: int, k: int) -> Block:
        """Part k of block i: BLOCK // PARTS queries drawn from the content
        seed, in the order drawn."""
        n = BLOCK // PARTS
        rng = np.random.default_rng([self.content_seed, 0x51, int(i), int(k)])
        cls = rng.choice(len(self.classes), size=n, p=self.p).astype(np.int16)
        words: list[np.ndarray | None] = [None] * n
        kw: list[np.ndarray | None] = [None] * n
        ph: list[np.ndarray | None] = [None] * n
        quoted = np.zeros(n, bool)
        empty = np.zeros(0, np.int64)
        phrase_rows = {}
        for ci, c in enumerate(self.classes):
            rows = np.flatnonzero(cls == ci)
            m = rows.size
            if m == 0:
                continue
            if "keywords" in c:
                cols = [rng.choice(self.class_words[k], size=m) for k in c["keywords"]]
                ranks = np.stack(cols, axis=1) if cols else np.zeros((m, 0), np.int64)
                for j, r in zip(rows.tolist(), ranks):
                    words[j], kw[j], ph[j] = r, r, empty
            elif "phrase" in c:
                phrase_rows[ci] = rows
            elif "question" in c:
                for j, (w, q) in zip(rows.tolist(), self._questions(c["question"], m, rng)):
                    words[j], kw[j], ph[j] = w, q, empty
            else:
                raise ValueError(f"traffic class {c.get('name')!r} has no known kind")
        for ci, runs in self._phrases(phrase_rows, rng).items():
            for j, r in zip(phrase_rows[ci].tolist(), runs):
                words[j], kw[j], ph[j] = r, empty, r
                quoted[j] = True
        return Block(words=words, quoted=quoted, cls=cls, kw=kw, ph=ph)

    def _phrases(self, phrase_rows: dict, rng) -> dict:
        """For each phrase class, as many runs of adjacent body tokens of
        random documents as it has rows, the rarest word's body df share
        in its class; the classes of one length share the draws. Docs are
        drawn by their content index, so the runs do not depend on the doc
        ids. -> {class index: int64 [rows, words]}."""
        coll, tok, df = self.coll, self.coll.body.tok, self.coll.body.df
        out = {}
        by_len = {}
        for ci in phrase_rows:
            by_len.setdefault(int(self.classes[ci]["phrase"]["words"]), []).append(ci)
        for n_words, group in by_len.items():
            got = {ci: [] for ci in group}
            need = {ci: phrase_rows[ci].size for ci in group}
            while any(need.values()):
                m = 4096
                doc = coll.row_of[rng.integers(0, coll.n_docs, m)]
                room = self.lengths[doc] - n_words + 1
                ok = room > 0
                doc = doc[ok]
                start = (rng.random(doc.size) * room[ok]).astype(np.int64)
                run = np.stack([tok[doc, start + k] for k in range(n_words)],
                               axis=1).astype(np.int64)
                share = df[run].min(axis=1) / float(coll.n_docs)
                for ci in group:
                    if need[ci]:
                        bounds = self.bounds[self.classes[ci]["phrase"]["df"]]
                        keep = run[_in_class(share, bounds)][: need[ci]]
                        got[ci].append(keep)
                        need[ci] -= len(keep)
            for ci in group:
                out[ci] = np.concatenate(got[ci])
        return out

    def _questions(self, q: dict, m: int, rng) -> list[tuple[np.ndarray, np.ndarray]]:
        n_w = np.minimum(int(q["base_words"]) + rng.poisson(float(q["poisson_mean"]), m),
                         int(q["max_words"]))
        total = int(n_w.sum())
        is_stop = rng.random(total) < float(q["stopword_share"])
        starts = np.cumsum(n_w) - n_w
        # a question with no content word gets one at a random slot
        n_content = np.add.reduceat((~is_stop).astype(np.int64), starts)
        fix = np.flatnonzero(n_content == 0)
        is_stop[starts[fix] + (rng.random(fix.size) * n_w[fix]).astype(np.int64)] = False
        # df-weighted ranks; the draws searched in sorted order (cache-friendly)
        u = rng.random(total) * self.df_cdf[-1]
        order = np.argsort(u, kind="stable")
        content = np.empty(total, np.int64)
        content[order] = np.searchsorted(self.df_cdf, u[order], side="right")
        stop_ix = len(self.df_cdf) + rng.integers(0, self.n_stop, total)
        words = np.where(is_stop, stop_ix, content)
        keep = ~is_stop
        return [(words[s: s + k], content[s: s + k][keep[s: s + k]])
                for s, k in zip(starts.tolist(), n_w.tolist())]


class Cursor:
    """The stream from block `first` on (at most `blocks` blocks when
    given). `prefetch` draws one part of a block ahead of the loop; `take`
    spells a batch's texts as the loop takes it. `stream` is every query
    taken so far, with the ranks of every query drawn."""

    def __init__(self, traffic: Traffic, first: int = 0, blocks: int | None = None):
        self.traffic, self.next = traffic, int(first)
        self.end = None if blocks is None else int(first) + int(blocks)
        self.parts: list[Block] = []  # the next block's parts drawn so far
        self.texts: list[str] = []
        self.words: list[np.ndarray] = []
        self.quoted: list[bool] = []
        self.cls: list[np.ndarray] = []
        self.kw: list[np.ndarray] = []
        self.ph: list[np.ndarray] = []

    def _step(self) -> bool:
        """Draw the next part; a block whose parts are all drawn joins the
        stretch. False where the stretch has ended."""
        if self.end is not None and self.next >= self.end:
            return False
        self.parts.append(self.traffic.part(self.next, len(self.parts)))
        if len(self.parts) == PARTS:
            b = self.traffic.block(self.next, self.parts)
            self.next, self.parts = self.next + 1, []
            self.words += b.words
            self.quoted += b.quoted.tolist()
            self.cls.append(b.cls)
            self.kw += b.kw
            self.ph += b.ph
        return True

    def prefetch(self, pos: int) -> None:
        """Draw one part of the next block while less than a block and a
        half lies drawn ahead of `pos`, so that `take` finds its texts'
        numbers drawn."""
        if len(self.words) < pos + BLOCK + BLOCK // 2:
            self._step()

    def take(self, pos: int, n: int) -> list[str]:
        """The texts [pos, pos + n) of the stretch, fewer where it ends."""
        while len(self.words) < pos + n and self._step():
            pass
        stop = min(pos + n, len(self.words))
        self.texts += [self.traffic.text(self.words[j], self.quoted[j])
                       for j in range(len(self.texts), stop)]
        return self.texts[pos: stop]

    @property
    def stream(self) -> Stream:
        cls = np.concatenate(self.cls) if self.cls else np.zeros(0, np.int16)
        return Stream(self.texts, cls, self.traffic.class_names, self.kw, self.ph)


def _flat(arrays: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    lengths = np.array([a.size for a in arrays], np.int64)
    flat = np.concatenate(arrays).astype(np.int64) if arrays else np.zeros(0, np.int64)
    return flat, lengths


def _produce(flow: Traffic, first: int, end: int | None, conn, reader) -> None:
    """The child of a Feed: blocks from `first` on, each spelled and sent
    whole (texts joined by newlines, ranks flat), until `end` or until the
    Feed stops reading; an empty message ends the stream."""
    reader.close()  # the copy of the Feed's end, so that its close ends the pipe
    i = first
    try:
        while end is None or i < end:
            b = flow.block(i)
            texts = "\n".join(flow.text(w, q) for w, q in zip(b.words, b.quoted.tolist()))
            conn.send_bytes(pickle.dumps((texts, b.cls, _flat(b.kw), _flat(b.ph)),
                                         protocol=pickle.HIGHEST_PROTOCOL))
            i += 1
        conn.send_bytes(b"")
    except OSError:  # the Feed closed its end
        pass
    finally:
        conn.close()


class Feed:
    """The stream from block `first` on (at most `blocks` blocks), drawn
    and spelled by a child process forked from this one, so that the
    window's host loop carries none of the generator's work. The same
    stream as a Cursor's, with its `take`, `prefetch` and `stream`. The
    child only reads the shard's host arrays (it never touches the card)
    and sends whole blocks; `prefetch` takes in at most one received block
    a call, up to AHEAD blocks ahead. `close` ends the child and waits for
    it."""

    def __init__(self, flow: Traffic, first: int = 0, blocks: int | None = None):
        end = None if blocks is None else int(first) + int(blocks)
        ctx = multiprocessing.get_context("fork")
        self._conn, child_end = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_produce, daemon=True,
                                 args=(flow, int(first), end, child_end, self._conn))
        with warnings.catch_warnings():
            # the child reads host arrays and writes a pipe: no lock of the
            # parent's other threads (CUDA's, the profiler's) is in its path
            warnings.filterwarnings("ignore", "This process .* is multi-threaded",
                                    DeprecationWarning)
            self._proc.start()
        child_end.close()
        self.class_names = flow.class_names
        self.texts: list[str] = []
        self._parts: list[tuple] = []  # per block: cls, (kw flat, lengths), (ph flat, lengths)
        self.ended = False
        while len(self._parts) < AHEAD and self._receive():
            pass

    def _receive(self) -> bool:
        """Take in one block (waiting for it); False once the stream ended."""
        if self.ended:
            return False
        if not self._conn.poll(WAIT_S):
            raise RuntimeError(f"the stream's child sent no block in {WAIT_S} s")
        try:
            data = self._conn.recv_bytes()
        except EOFError:
            data = b""
        if not data:
            self.ended = True
            return False
        texts, cls, kw, ph = pickle.loads(data)
        self.texts += texts.split("\n")
        self._parts.append((cls, kw, ph))
        return True

    def prefetch(self, pos: int) -> None:
        if len(self.texts) < pos + AHEAD * BLOCK and not self.ended and self._conn.poll():
            self._receive()

    def take(self, pos: int, n: int) -> list[str]:
        while len(self.texts) < pos + n and self._receive():
            pass
        return self.texts[pos: pos + n]

    def close(self) -> None:
        self._conn.close()
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()

    @property
    def stream(self) -> Stream:
        def split(pairs):
            return [a for flat, n in pairs for a in np.split(flat, np.cumsum(n)[:-1])]

        cls = (np.concatenate([c for c, _, _ in self._parts]) if self._parts
               else np.zeros(0, np.int16))
        return Stream(self.texts, cls, self.class_names,
                      split([k for _, k, _ in self._parts]),
                      split([p for _, _, p in self._parts]))


def make_stream(mix: dict, coll: Collection, n: int, seed: int,
                content_seed: int | None = None, first: int = 0) -> Stream:
    """The first n queries of the mix's stream from block `first` on."""
    cur = Cursor(Traffic(mix, coll, seed, content_seed), first)
    cur.take(0, n)
    s = cur.stream
    return Stream(s.texts[:n], s.cls[:n], s.class_names, s.kw[:n], s.ph[:n])
