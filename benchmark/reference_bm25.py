"""The plain reference of a search shard ranked by Okapi BM25.

Plain PyTorch over the raw collection (collection.Collection's token
matrices), as reference.py is for the blend: it imports nothing of the
port and takes nothing the port or the snapshot made. It counts the
tokens again, weights them again and scores every document of the shard
for one query at a time. The query parse, the phrase chain and the top-k
are reference.py's.

Semantics, per section (title, body):
- tf: a word's occurrences in the doc's section; dl: the doc's content
  tokens in the section; avgdl: their sum over the shard's N docs over N;
- idf = ln((N - df + 0.5) / (df + 0.5) + 1), in f64;
- w = idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl)), in f64,
  rounded to f32;
- a keyword adds its w once for each time it occurs in the query;
- all of a query's phrase spans join into one chain; a section where the
  chain occurs at consecutive positions adds the sum of the chain tokens'
  w there;
- a doc is a candidate if either section has a keyword posting or a
  phrase match; final = title_boost * S_title + body_boost * S_body over
  candidates, -inf elsewhere.

Where it departs from Lucene's BM25Similarity:
- the (k1 + 1) factor, which Lucene 8 dropped: a constant scale, so the
  order is unchanged;
- dl exact, where Lucene stores it as a one-byte norm;
- a phrase scores as the sum of its tokens' weights, not as BM25 of the
  phrase's frequency;
- fields sum with boosts, as Elasticsearch's multi_match of type
  most_fields does.

The constants are Lucene's (k1 1.2, b 0.75) and the port's boosts (title
2, body 1). `dtype` sets the precision of the weights and sums: float32
is the reference; bfloat16 is the control (the nearest precision below),
which the comparison must refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference

#: Lucene's BM25Similarity defaults, and the port's field boosts
K1, B, TITLE_BOOST, BODY_BOOST = 1.2, 0.75, 2.0, 1.0


class _Section(reference._Section):
    """One section's BM25 weight per (word, doc) posting, in the blend
    section's layout, so its postings, chain and weights serve as they
    are."""

    def __init__(self, tok: np.ndarray, n_docs: int, vocab_size: int, device, dtype):
        t = torch.from_numpy(np.ascontiguousarray(tok)).to(device)
        real = t >= 0
        doc = torch.arange(n_docs, device=device)[:, None].expand_as(t)[real]
        key = doc * vocab_size + t[real].long()
        ukey, tf = torch.unique(key, return_counts=True)
        pdoc, prank = ukey // vocab_size, ukey % vocab_size
        df = torch.bincount(prank, minlength=vocab_size)
        dl = real.sum(dim=1).double()
        avgdl = dl.sum() / n_docs
        idf = torch.log((n_docs - df.double() + 0.5) / (df.double() + 0.5) + 1.0)
        tf = tf.double()
        w = (idf[prank] * tf * (K1 + 1.0)
             / (tf + K1 * (1.0 - B + B * dl[pdoc] / avgdl))).float()
        order = torch.argsort(prank * n_docs + pdoc)
        self.docs = pdoc[order]
        self.w = w[order].to(dtype)
        off = torch.zeros(vocab_size + 1, dtype=torch.int64)
        off[1:] = torch.cumsum(df.cpu(), 0)
        self.offsets = off.numpy()
        self.tok = t
        self.n_docs, self.dtype = n_docs, dtype


class Reference(reference.Reference):
    def __init__(self, title_tok, body_tok, words: list[str], stopwords, device,
                 dtype=torch.float32):
        self.n_docs = int(body_tok.shape[0])
        self.vocab = {w: r for r, w in enumerate(words)}
        self.stop = frozenset(stopwords)
        self.device, self.dtype = torch.device(device), dtype
        v = len(words)
        self.title = _Section(title_tok, self.n_docs, v, self.device, dtype)
        self.body = _Section(body_tok, self.n_docs, v, self.device, dtype)

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
        final = TITLE_BOOST * score["title"] + BODY_BOOST * score["body"]
        final = torch.where(cand, final, torch.full_like(final, -float("inf")))
        return final.float()
