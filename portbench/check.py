"""The comparison that decides `correct`.

Every answer the program gave that is compared (all of them, or a sample
drawn from the seed) is held against the plain reference's answer symbol
by symbol.  Arithmetic over F_q is exact, so the limit on mismatched
symbols is 0; a run that compared nothing is not correct either.  (The
drivers' ops are synchronous: an answer that never comes, or an error,
ends the run with no result.)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ROW_BLOCK = 16  # rows compared at a time, to bound the host's memory


@dataclass
class Tally:
    answers: int = 0            # answers compared
    wrong_answers: int = 0      # answers with at least one wrong symbol
    mismatched: int = 0         # symbols that differ from the reference

    def compare(self, got, want) -> int:
        """Hold one answer against the reference's; returns its mismatched
        symbols (the whole answer when the shapes differ)."""
        got, want = np.asarray(got), np.asarray(want)
        self.answers += 1
        if got.shape != want.shape:
            bad = want.size
        else:
            g2 = got.reshape(got.shape[0], -1) if got.ndim else got.reshape(1, 1)
            w2 = want.reshape(g2.shape)
            bad = sum(int(np.count_nonzero(g2[r:r + ROW_BLOCK]
                                           != w2[r:r + ROW_BLOCK]))
                      for r in range(0, g2.shape[0], ROW_BLOCK))
        self.mismatched += bad
        self.wrong_answers += bool(bad)
        return bad

    def checks(self) -> list[dict]:
        """The numbers compared, each with its limit: `value <= limit`, or
        `value >= limit` where the rule says so."""
        return [
            {"name": "mismatched_symbols", "value": self.mismatched,
             "limit": 0, "rule": "<="},
            {"name": "answers_compared", "value": self.answers, "limit": 1,
             "rule": ">="},
        ]


def passed(checks: list[dict]) -> bool:
    return all(c["value"] >= c["limit"] if c["rule"] == ">="
               else c["value"] <= c["limit"] for c in checks)
