"""The one traffic generator: reads a ``bench/traffic/*.json`` mix and makes
its prompts and batches from the seed.

A mix is a closed loop of whole batches of ``batch`` requests that share one
prompt length (the engine's requirement); the next batch starts when the last
one returns.  Kinds:

* ``revisit``: set-up prefills ``pool`` documents of ``prompt_tokens`` through
  the engine's miss path, ``fill_per_prefill`` a call, which saves them to the
  host store; each batch then asks again about ``batch`` distinct documents
  drawn uniformly from the pool, so every request is a hit.
* ``fresh``: each batch brings ``batch`` new prompts, so every request is a miss.

Every seed gives the same sizes; only the token ids and the order of the
documents differ.  Token ids are uniform over the vocabulary.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("revisit", "fresh")


@dataclasses.dataclass(frozen=True)
class Batch:
    index: int
    keys: list[str]
    prompts: np.ndarray          # [batch, prompt_tokens] int64
    docs: tuple[int, ...] | None  # the pool documents asked about (revisit)


@dataclasses.dataclass(frozen=True)
class Check:
    """One served prefill call as the reference replays it: its prompts
    [G, prompt_tokens], and the requests to check, (row in the call, window
    batch, row in that batch)."""
    prompts: np.ndarray
    requests: list[tuple[int, int, int]]


def _seed(seed: int) -> int:
    return seed % (1 << 63)


class Mix:
    def __init__(self, spec: dict, vocab: int, seed: int):
        if spec["kind"] not in KINDS:
            raise ValueError(f"unknown traffic kind {spec['kind']!r}; known: {KINDS}")
        self.kind = spec["kind"]
        self.batch = int(spec["batch"])
        self.prompt_tokens = int(spec["prompt_tokens"])
        self.new_tokens = int(spec["new_tokens"])
        self.check_requests = int(spec["check_requests"])
        self.vocab = vocab
        self.seed = _seed(seed)
        self.hit = self.kind == "revisit"
        self._pool = None
        if self.hit:
            self.pool = int(spec["pool"])
            self.fill_per_prefill = int(spec["fill_per_prefill"])
            if self.pool < self.batch:
                raise ValueError(f"a pool of {self.pool} cannot give {self.batch} distinct documents")

    def _rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *stream])

    def _tokens(self, rng, rows: int) -> np.ndarray:
        return rng.integers(0, self.vocab, (rows, self.prompt_tokens), dtype=np.int64)

    def pool_prompts(self) -> np.ndarray:
        """[pool, prompt_tokens]: the documents set-up saves (revisit)."""
        if self._pool is None:
            self._pool = self._tokens(self._rng(1), self.pool)
        return self._pool

    @staticmethod
    def doc_key(doc: int) -> str:
        return f"doc-{doc}"

    def fill(self):
        """(keys, prompts) of the set-up prefills that fill the pool."""
        for docs in self.fill_groups():
            yield [self.doc_key(d) for d in docs], self.pool_prompts()[docs]

    def batch_at(self, index: int, phase: str = "window") -> Batch:
        """Batch ``index`` of ``phase`` ("warm" for the warm-up, "window")."""
        rng = self._rng(2 if phase == "warm" else 3, index)
        if self.hit:
            docs = tuple(int(d) for d in rng.choice(self.pool, self.batch, replace=False))
            return Batch(index, [self.doc_key(d) for d in docs],
                         self.pool_prompts()[list(docs)], docs)
        return Batch(index, [f"{phase}-{index}-{b}" for b in range(self.batch)],
                     self._tokens(rng, self.batch), None)

    def fill_groups(self) -> list[list[int]]:
        """The documents of each set-up prefill call, in order."""
        return [list(range(lo, min(lo + self.fill_per_prefill, self.pool)))
                for lo in range(0, self.pool, self.fill_per_prefill)]

    def check_plan(self, window: list[Batch]) -> list[Check]:
        """The served calls whose requests the reference checks, drawn from
        the seed, whole, until ``check_requests`` requests are covered: a
        fresh mix's prefill batches, with every request of each; a revisit
        mix's fill calls, with one window request of each document in it
        (where the window asked about it)."""
        rng = self._rng(4)
        plan, n = [], 0
        if not self.hit:
            for bi in rng.permutation(len(window)):
                if n >= self.check_requests:
                    break
                b = window[int(bi)]
                plan.append(Check(b.prompts, [(g, b.index, g) for g in range(self.batch)]))
                n += self.batch
            return plan
        asked: dict[int, list[tuple[int, int]]] = {}
        for b in window:
            for row, doc in enumerate(b.docs):
                asked.setdefault(doc, []).append((b.index, row))
        groups = self.fill_groups()
        for gi in rng.permutation(len(groups)):
            if n >= self.check_requests:
                break
            docs = groups[int(gi)]
            reqs = []
            for g, doc in enumerate(docs):
                if asked.get(doc):
                    bi, row = asked[doc][int(rng.integers(len(asked[doc])))]
                    reqs.append((g, bi, row))
            if reqs:
                plan.append(Check(self.pool_prompts()[docs], reqs))
                n += len(reqs)
        return plan
