"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that this module reads.

Two kinds of mix, named by the driver that sends them (``driver``):

* ``prefill``: one closed-loop client; request ``i`` is a batch of ``batch``
  prompts of one length.  Requests come in cycles of ``cycle``: the last of
  each cycle is a long document of ``long_length`` tokens, the others take
  the ``cycle - 1`` lengths at the mid-quantiles of a log-uniform law over
  [``min_length``, ``max_length``], rounded to a multiple of ``multiple``.
  Every seed sends the same lengths, in an order the seed shuffles within
  each cycle, so a seed changes the order of the work and never its amount.
  The token ids are uniform over the vocabulary.
* ``train``: steps of ``batch`` rows of ``seq_len`` tokens, uniform ids,
  each step's rows drawn afresh (no two rows alike); labels are the next
  tokens and every position counts.

Every draw comes from ``--seed`` and the request's or step's index, so
set-up, the window and the check after it remake the same tensors.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Tuple

import torch

from perfbench.harness.weights import generator, subseed


def short_lengths(t: Dict[str, Any]) -> List[int]:
    """The ``cycle - 1`` prompt lengths of a prefill cycle other than the long one."""
    n, lo, hi, m = t["cycle"] - 1, t["min_length"], t["max_length"], t["multiple"]
    out = []
    for k in range(n):
        x = math.exp(math.log(lo) + (k + 0.5) / n * (math.log(hi) - math.log(lo)))
        out.append(min(hi, max(lo, m * round(x / m))))
    return out


class Traffic:
    def __init__(self, spec: Dict[str, Any], seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, seed, vocab

    # -- prefill ---------------------------------------------------------------

    def length(self, i: int) -> int:
        """The prompt length of request ``i``."""
        t = self.spec
        c, pos = divmod(i, t["cycle"])
        if pos == t["cycle"] - 1:
            return t["long_length"]
        order = random.Random(subseed(self.seed, "cycle", c)).sample(
            short_lengths(t), t["cycle"] - 1)
        return order[pos]

    def shapes(self) -> List[Tuple[int, int]]:
        """Every (batch, length) a prefill mix sends: the shapes to warm up."""
        t = self.spec
        return [(t["batch"], n) for n in sorted(set(short_lengths(t)) | {t["long_length"]})]

    def prompt(self, i: int, device: torch.device) -> torch.Tensor:
        """Request ``i``'s token ids [batch, length]."""
        g = generator(device, self.seed, "prompt", i)
        return torch.randint(0, self.vocab, (self.spec["batch"], self.length(i)),
                             generator=g, device=device)

    def is_long(self, i: int) -> bool:
        return i % self.spec["cycle"] == self.spec["cycle"] - 1

    # -- train -----------------------------------------------------------------

    def batch(self, i: int, device: torch.device) -> Dict[str, torch.Tensor]:
        """Step ``i``'s batch: tokens, labels (the next tokens), mask."""
        b, l = self.spec["batch"], self.spec["seq_len"]
        g = generator(device, self.seed, "batch", i)
        seq = torch.randint(0, self.vocab, (b, l + 1), generator=g, device=device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:],
                "mask": torch.ones((b, l), dtype=torch.float32, device=device)}

    # -- the check -------------------------------------------------------------

    def check_sample(self) -> List[int]:
        """The requests whose outputs the check holds against the reference:
        ``check_requests`` of the first ``check_from`` (whole cycles, which
        every window finishes), drawn from the seed, a long one among them."""
        t = self.spec
        first, k = t["check_from"], t["check_requests"]
        rng = random.Random(subseed(self.seed, "check"))
        longs = [i for i in range(first) if self.is_long(i)]
        pick = [rng.choice(longs)]
        pick += rng.sample([i for i in range(first) if i not in pick], k - 1)
        return sorted(pick)
