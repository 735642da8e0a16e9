#
# The global row layout of a multi-process fit: the port's copy of
# spark_rapids_ml_tpu/parallel/partition.py. Every rank states how many rows
# it holds through the rendezvous, so each knows (m, n, the rows of every
# rank, its own rank) before it solves.
#
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass
class PartitionDescriptor:
    """Global row layout: which rank holds how many rows, plus (m, n)."""

    parts_rank_size: List[Tuple[int, int]]  # [(rank, rows of that rank's block), ...]
    m: int  # total rows
    n: int  # cols
    rank: int

    @classmethod
    def build(
        cls,
        partition_rows: Sequence[int],
        total_cols: int,
        rank: int = 0,
        rendezvous=None,
    ) -> "PartitionDescriptor":
        """Build the descriptor. One process passes every partition's row
        count; a rank of a multi-process fit passes its own counts and a
        `rendezvous` whose ``allgather`` merges them across ranks (one round
        of JSON strings)."""
        if rendezvous is not None:
            payload = json.dumps({"rank": rank, "rows": list(partition_rows)})
            pairs: List[Tuple[int, int]] = []
            for msg in rendezvous.allgather(payload):
                obj = json.loads(msg)
                pairs.extend((obj["rank"], r) for r in obj["rows"])
            pairs.sort()
        else:
            pairs = [(i, r) for i, r in enumerate(partition_rows)]
        m = sum(r for _, r in pairs)
        return cls(parts_rank_size=pairs, m=m, n=total_cols, rank=rank)

    def rows_of(self, rank: int) -> int:
        return sum(r for rk, r in self.parts_rank_size if rk == rank)

    def row_offset_of(self, rank: int) -> int:
        return sum(r for rk, r in self.parts_rank_size if rk < rank)
