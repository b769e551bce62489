"""Speculative decoding's draft side: the self-drafting n-gram
proposer, the pluggable draft hook and the per-request adaptive-k
policy.

Copy of ``paddle_tpu/serving/speculative.py`` (numpy only). A cheap
drafter proposes up to ``k`` next tokens of a request; the target model
scores the current token and the drafts as one ragged span of the
serving tick (``models.llama.serving_tick``'s ``spec_k`` verify mode),
and the longest prefix of drafts equal to the target's own picks is
accepted, so a slot emits ``1 + accepted`` tokens from one launch. The
output does not depend on what the drafter proposes: a draft is kept
only while it equals the token the target picks at that position (the
argmax, or the sampler's draw under the same ``fold_in`` key a plain
tick would use), and the first mismatch emits the target's own token.

Drafting is host-side and model-free by default (:class:`NGramDrafter`,
prompt-lookup decoding over the request's own history). Any object with
``propose(history, k) -> int32[<=k]``, or a bare callable of that
signature, plugs in through ``ServingEngine(speculative=...)``.
:class:`AcceptancePolicy` keeps a per-request EWMA of the acceptance
rate and sets each slot's draft budget from it: low-acceptance slots
fall back to plain decode, with a periodic probe draft so a stream that
turns predictable is found again.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["NGramDrafter", "AcceptancePolicy", "resolve_drafter"]


class NGramDrafter:
    """Self-drafting / prompt-lookup proposer.

    ``propose(history, k)`` searches the request's own token history
    (prompt + everything generated so far) for the most recent earlier
    occurrence of the current suffix n-gram — longest ``n`` first,
    down to ``min_ngram`` — and proposes the ``k`` tokens that
    followed that occurrence. Zero model cost, and exactly the right
    shape for the two workloads speculation wins on: repetitive
    generation (greedy decode of any fixed model is eventually
    periodic — once one period is in the history the drafter predicts
    the next perfectly) and prompts the answer quotes from.
    Returns an int32 array of length ``<= k`` (empty = no match, the
    slot decodes plainly this tick).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_history: int = 1024):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_history = int(max_history)

    def propose(self, history, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)[-self.max_history:]
        empty = np.empty((0,), np.int32)
        if k < 1 or h.size < self.min_ngram + 1:
            return empty
        best = empty
        for n in range(min(self.max_ngram, h.size - 1),
                       self.min_ngram - 1, -1):
            pat = h[-n:]
            # windows over h[:-1]: the trivial self-match (the suffix
            # itself) ends at h[-1] and is excluded by construction
            win = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.flatnonzero((win == pat).all(axis=1))
            # most recent match with a FULL k-token continuation wins:
            # inside a repeated run the very latest match sits at the
            # history's edge with only a token or two after it, while
            # one period earlier the whole next period is available —
            # a truncated draft would cap acceptance at its own length
            for i in hits[::-1]:
                cont = h[i + n: i + n + k]
                if cont.size == k:
                    return np.ascontiguousarray(cont, np.int32)
                if cont.size > best.size:
                    best = cont
        return np.ascontiguousarray(best, np.int32)


class AcceptancePolicy:
    """Per-request adaptive draft budget from a running acceptance
    EWMA (the acceptance-aware half of the scheduler).

    ``budget(state, remaining)`` -> draft tokens the slot may submit
    this tick (0 = plain decode); ``update(state, drafted, accepted)``
    folds one verify result in. ``state`` is any object with mutable
    ``spec_rate`` / ``spec_probe`` attributes (the engine uses the
    Request itself). The EWMA starts optimistic (1.0 — the first
    drafts always get a chance); once it falls under ``floor`` the
    slot degrades to plain decode except for one probe draft every
    ``probe_every`` opportunities, so acceptance can recover when the
    stream turns predictable again."""

    def __init__(self, k: int, *, ewma: float = 0.25,
                 floor: float = 0.125, probe_every: int = 8):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        self.k = int(k)
        self.ewma = float(ewma)
        self.floor = float(floor)
        self.probe_every = int(probe_every)

    def budget(self, state, remaining: int) -> int:
        """Draft tokens allowed this tick: the EWMA scales the cap
        (drafting k costs k span rows whether accepted or not, so an
        uncertain slot drafts short and a locked-on slot drafts full).
        ``remaining`` additionally caps drafts at the request's funded
        page budget (max_new_tokens - produced - 1 cache positions are
        still fundable; beyond that draft KV would only land on the
        trash page — harmless but wasted)."""
        cap = min(self.k, int(remaining))
        if cap <= 0:
            return 0
        if state.spec_rate < self.floor:
            state.spec_probe += 1
            if state.spec_probe % self.probe_every:
                return 0            # degraded: plain decode, mostly
            return 1                # periodic probe draft
        return max(1, min(cap, int(state.spec_rate * self.k + 0.5)))

    def update(self, state, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        rate = accepted / drafted
        state.spec_rate = ((1.0 - self.ewma) * state.spec_rate
                           + self.ewma * rate)


class _CallableDrafter:
    """Adapter: a bare ``fn(history, k) -> tokens`` as a drafter."""

    def __init__(self, fn):
        self._fn = fn

    def propose(self, history, k: int) -> np.ndarray:
        return np.asarray(self._fn(history, k), np.int32).reshape(-1)


def resolve_drafter(spec) -> Optional[object]:
    """Normalize ``ServingEngine(speculative=...)``: None/False -> off;
    True/"ngram" -> the default :class:`NGramDrafter`; an object with
    ``propose`` passes through (the draft-model hook); a bare callable
    is wrapped."""
    if spec in (None, False, "off", "none"):
        return None
    if spec in (True, "ngram"):
        return NGramDrafter()
    if hasattr(spec, "propose"):
        return spec
    if callable(spec):
        return _CallableDrafter(spec)
    raise ValueError(
        f"speculative must be None/True/'ngram', an object with "
        f"propose(history, k), or a callable — got {spec!r}")
