"""The plain reference of the search shard: the reference blend restated.

Plain PyTorch over the raw collection (collection.Collection's token
matrices). It imports nothing of the port and takes nothing the port or
the snapshot made: it counts the tokens again, weights them again and
scores every document of the shard for one query at a time.

Semantics (the Go reference's retrieval math, as the port's docstrings
and oracle state it):
- parse: quoted spans are phrases; all of them join into one token chain;
  the rest are keywords; tokens are alphanumeric runs, lowercased, minus
  stopwords; query_len = keyword tokens + phrase tokens;
- weight of a word in a doc's section: normTF * idf, normTF = tf / the
  section's max tf (f64, rounded to f32), idf = log2(N / df) per section
  (f64, rounded to f32), multiplied in f32; a section's magnitude = sqrt of
  the f64 sum of its squared weights;
- keyword score per section: the sum of the doc's weights over the query's
  keywords, each occurrence counted;
- a phrase matches a section where its tokens occur at consecutive
  positions; a matching section adds the sum of the phrase tokens'
  weights there; a phrase-matched doc is a candidate;
- score = (0.33 * sqd + 0.38 * title / (|title| sqrt(qlen)) + 0.29 * body /
  (|body| sqrt(qlen))) * 100 over candidates (a keyword posting or a phrase
  match), NaN (0/0) taken as 0; sqd = 0, as the topic model ships off;
- top-k: score descending, ties by ascending doc id.

`dtype` sets the precision of the weights, magnitudes and sums: float32 is
the reference; bfloat16 is the control (the nearest precision below), which
the comparison must refuse.
"""

from __future__ import annotations

import re

import numpy as np
import torch

#: the reference blend and scale (get_metadata.go:69, restated)
W_PAGERANK, W_TITLE, W_BODY, SCALE = 0.33, 0.38, 0.29, 100.0

_PHRASE_RE = re.compile(r'".*?"')
_TOKEN_RE = re.compile(r"[a-zA-Z0-9]+")


class _Section:
    def __init__(self, tok: np.ndarray, n_docs: int, vocab_size: int, device, dtype):
        t = torch.from_numpy(np.ascontiguousarray(tok)).to(device)
        real = t >= 0
        doc = torch.arange(n_docs, device=device)[:, None].expand_as(t)[real]
        key = doc * vocab_size + t[real].long()
        ukey, tf = torch.unique(key, return_counts=True)
        pdoc, prank = ukey // vocab_size, ukey % vocab_size
        maxtf = torch.zeros(n_docs, dtype=tf.dtype, device=device)
        maxtf.scatter_reduce_(0, pdoc, tf, "amax")
        ntf = (tf.double() / maxtf[pdoc].double()).float()
        df = torch.bincount(prank, minlength=vocab_size)
        idf = torch.log2(n_docs / df.double().clamp(min=1)).float()
        w = ntf * idf[prank]
        sq = torch.zeros(n_docs, dtype=torch.float64, device=device)
        sq.index_add_(0, pdoc, w.double().pow(2))
        self.mag = torch.sqrt(sq).to(dtype)
        order = torch.argsort(prank * n_docs + pdoc)
        self.docs = pdoc[order]
        self.w = w[order].to(dtype)
        off = torch.zeros(vocab_size + 1, dtype=torch.int64)
        off[1:] = torch.cumsum(torch.bincount(prank, minlength=vocab_size).cpu(), 0)
        self.offsets = off.numpy()
        self.tok = t
        self.n_docs, self.dtype = n_docs, dtype

    def postings(self, r: int):
        s, e = int(self.offsets[r]), int(self.offsets[r + 1])
        return self.docs[s:e], self.w[s:e]

    def chain(self, ranks: list[int]) -> torch.Tensor:
        """Docs where the ranks occur at consecutive positions."""
        k, width = len(ranks), self.tok.shape[1]
        if width < k:
            return torch.zeros(self.n_docs, dtype=torch.bool, device=self.tok.device)
        hit = self.tok[:, : width - k + 1] == ranks[0]
        for i in range(1, k):
            hit &= self.tok[:, i: width - k + 1 + i] == ranks[i]
        return hit.any(dim=1)

    def weight_of(self, r: int) -> torch.Tensor:
        out = torch.zeros(self.n_docs, dtype=self.dtype, device=self.tok.device)
        docs, w = self.postings(r)
        out[docs] = w
        return out


class Reference:
    def __init__(self, title_tok, body_tok, words: list[str], stopwords, device,
                 dtype=torch.float32):
        self.n_docs = int(body_tok.shape[0])
        self.vocab = {w: r for r, w in enumerate(words)}
        self.stop = frozenset(stopwords)
        self.device, self.dtype = torch.device(device), dtype
        v = len(words)
        self.title = _Section(title_tok, self.n_docs, v, self.device, dtype)
        self.body = _Section(body_tok, self.n_docs, v, self.device, dtype)

    def _tokens(self, text: str) -> list[str]:
        return [t for t in (m.lower() for m in _TOKEN_RE.findall(text)) if t not in self.stop]

    def parse(self, text: str) -> tuple[list, list]:
        """-> (keyword ranks, phrase ranks); None for a word not in the
        vocabulary (it matches nothing and still counts in query_len)."""
        phrases = [s[1:-1] for s in _PHRASE_RE.findall(text)]
        stripped = text
        for ph in phrases:
            stripped = stripped.replace('"' + ph + '"', "", 1)
        kw = [self.vocab.get(t) for t in self._tokens(stripped)]
        ph = [self.vocab.get(t) for t in self._tokens(" ".join(phrases))]
        return kw, ph

    def scores(self, text: str) -> torch.Tensor:
        """Every doc's score for the query, float32 [D], -inf off the
        candidates."""
        kw, ph = self.parse(text)
        d, dt, dev = self.n_docs, self.dtype, self.device
        sec = {"title": self.title, "body": self.body}
        score = {n: torch.zeros(d, dtype=dt, device=dev) for n in sec}
        cand = torch.zeros(d, dtype=torch.bool, device=dev)
        for r in kw:
            if r is None:
                continue
            for n, s in sec.items():
                docs, w = s.postings(r)
                score[n].index_add_(0, docs, w)
                cand[docs] = True
        if ph and None not in ph:
            for n, s in sec.items():
                match = s.chain(ph)
                total = torch.zeros(d, dtype=dt, device=dev)
                for r in ph:
                    total += s.weight_of(r)
                score[n] += torch.where(match, total, torch.zeros_like(total))
                cand |= match
        qmag = torch.sqrt(torch.tensor(float(len(kw) + len(ph)), dtype=dt, device=dev))
        t_n = torch.nan_to_num(score["title"] / (self.title.mag * qmag), nan=0.0,
                               posinf=float("inf"), neginf=-float("inf"))
        b_n = torch.nan_to_num(score["body"] / (self.body.mag * qmag), nan=0.0,
                               posinf=float("inf"), neginf=-float("inf"))
        sqd = torch.zeros_like(t_n)
        final = (W_PAGERANK * sqd + W_TITLE * t_n + W_BODY * b_n) * SCALE
        final = torch.where(cand, final, torch.full_like(final, -float("inf")))
        return final.float()


def top_k(final: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Score descending, ties by ascending doc id."""
    vals, ids = torch.sort(final, descending=True, stable=True)
    return vals[:k], ids[:k]
