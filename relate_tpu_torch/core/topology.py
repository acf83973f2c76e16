"""Result records of the topology builder.

Only the two dataclasses that the device section builder
(``core/topology_device.py``) and the ``.anc``/``.mut`` writers share. The
host-driven builder of ``AncesTreeBuilder::BuildTopology`` (sample ages,
unknown ancestral allele) is not in this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .trees import AncesTree


@dataclass
class MutationRecord:
    tree: int = 0
    branch: List[int] = field(default_factory=list)
    flipped: bool = False
    age_begin: float = 0.0
    age_end: float = 0.0

    @property
    def is_not_mapping(self) -> bool:
        return len(self.branch) > 1


@dataclass
class SectionResult:
    anc: AncesTree
    muts: List[MutationRecord]   # for snps [start, end]
    start: int
    end: int
