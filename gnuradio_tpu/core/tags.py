"""Stream tags: host-side sideband metadata at absolute item offsets.

Reference parity:
  gnuradio-runtime/include/gnuradio/tags.h:19-40 — tag_t{offset, key, value,
      srcid}; offsets are ABSOLUTE uint64 item counts since stream start
  gnuradio-runtime/lib/buffer.cc:208-350 — tags stored keyed by absolute
      offset alongside the sample buffer
  gnuradio-runtime/lib/block_executor.cc:86-214 — propagate_tags: policies
      ALL_TO_ALL / ONE_TO_ONE / DONT; offsets scaled by the block's relative
      rate with EXACT rational arithmetic when set (mpq, :139-153)

Design: samples live on device inside one fused XLA step; tags ride on
the HOST in per-edge lists, advanced once per step by the runtime using the
same exact `fractions.Fraction` rate algebra the graph compiler solved.
Offset scaling is integer/rational host math (SURVEY.md App. C: "use int64 +
exact rational arithmetic for metadata, never float64"). Blocks that create
or consume tags data-dependently do so via `transform_tags` overrides; pure
DSP blocks just declare a policy.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any

# tag propagation policies (gnuradio/block.h:68-77)
TPP_DONT = "dont"
TPP_ALL_TO_ALL = "all_to_all"
TPP_ONE_TO_ONE = "one_to_one"


@dataclasses.dataclass(frozen=True, order=True)
class Tag:
    offset: int           # absolute item offset (uint64 in the reference)
    key: str
    value: Any = dataclasses.field(compare=False, default=None)
    srcid: str = dataclasses.field(compare=False, default="")

    def shifted(self, delta: int) -> "Tag":
        return Tag(self.offset + delta, self.key, self.value, self.srcid)

    def scaled(self, rrate: Fraction) -> "Tag":
        """Exact rational offset scaling (block_executor.cc:139-153)."""
        return Tag(int(self.offset * rrate), self.key, self.value, self.srcid)


class TagStream:
    """Per-edge tag storage ordered by offset (buffer.cc tag multimap)."""

    def __init__(self):
        self._tags: list[Tag] = []

    def add(self, tag: Tag):
        self._tags.append(tag)

    def extend(self, tags):
        self._tags.extend(tags)

    def get_range(self, start: int, end: int) -> list[Tag]:
        """Tags with start <= offset < end (buffer.cc get_tags_in_range)."""
        return sorted(t for t in self._tags if start <= t.offset < end)

    def prune(self, before: int):
        """Drop tags below an offset (buffer.cc prune_tags)."""
        self._tags = [t for t in self._tags if t.offset >= before]

    def all(self) -> list[Tag]:
        return sorted(self._tags)


def propagate(tags_in: list[Tag], policy: str, rrate: Fraction) -> list[Tag]:
    """The block_executor propagate_tags core: scale offsets through a
    block. ALL_TO_ALL and ONE_TO_ONE coincide for the single-in/single-out
    fused blocks here; multi-port fan-out is handled by the runtime placing
    the returned list on every out edge (ALL_TO_ALL) or the matching port
    (ONE_TO_ONE)."""
    if policy == TPP_DONT:
        return []
    if rrate == 1:
        return list(tags_in)
    return [t.scaled(rrate) for t in tags_in]
