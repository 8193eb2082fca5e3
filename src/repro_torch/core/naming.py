"""Unique function naming & key derivation (paper §4.4).

Every datastore key a workflow touches derives from a *globally unique
function id*:

    {workflowId}/{name}_{step}[-it{iter}][-bindex-{branch stack}]

* ``workflowId`` — UUID minted at the entry function, propagated via the
  JointλObject; common prefix of every key, enabling prefix-scoped GC.
* ``step`` — execution stage.  For DAG edges the compiler assigns static
  topological levels (longest path from the entry), so peers of a fan-in
  always agree on the aggregator's step regardless of path lengths.
* ``iter`` — cycle counter; incremented on back-edges so loop bodies get
  fresh ids each iteration (the paper folds this into step; a separate
  counter keeps fan-in step agreement inside loop bodies).
* ``branch stack`` — one index per enclosing fan-out/map level, newest last,
  rendered ``0+1+0``.  Fan-out pushes the branch index; fan-in pops.

PopAndMerge (§4.4): the paper's prose example is ambiguous about which end of
the stack pops and how unequal-depth peers merge.  We implement the following
well-defined variant (noted in DESIGN.md):

  * the compiler records each node's static fan-out ``depth``;
  * a fan-in aggregator at depth ``d`` receives branch stack
    ``peer_stack[:d]`` — the common prefix of all peers' stacks, which every
    peer can compute locally and identically.  This is what makes the shared
    bitmap key derivable without any peer-to-peer communication.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

BITMAP_SUFFIX = "-bitmap"
OUTPUT_SUFFIX = "-output"
IVK_SUFFIX = "-ivk"


def fmt_branch(stack: Sequence[int]) -> str:
    return "+".join(str(i) for i in stack)


@dataclass(frozen=True)
class Control:
    """The 'Control' field of a JointλObject: everything naming needs."""

    workflow_id: str
    step: int = 0
    branch: Tuple[int, ...] = ()
    iteration: int = 0

    # ---- id / key derivation ------------------------------------------------

    def function_id(self, name: str) -> str:
        fid = f"{self.workflow_id}/{name}_{self.step}"
        if self.iteration:
            fid += f"-it{self.iteration}"
        if self.branch:
            fid += f"-bindex-{fmt_branch(self.branch)}"
        return fid

    def output_key(self, name: str) -> str:
        return self.function_id(name) + OUTPUT_SUFFIX

    def ivk_key(self, name: str) -> str:
        return self.function_id(name) + IVK_SUFFIX

    # ---- transitions ----------------------------------------------------------

    # (direct construction, not dataclasses.replace — these are hot on the
    # simulator's per-hop path and replace() re-runs field introspection)

    def advance(self, next_step: int) -> "Control":
        """Sequence/Choice hop to a node at static level ``next_step``."""
        return Control(self.workflow_id, next_step, self.branch, self.iteration)

    def push_branch(self, index: int, next_step: int) -> "Control":
        """Fan-out / Map hop: push the branch index for the target."""
        return Control(self.workflow_id, next_step, self.branch + (index,),
                       self.iteration)

    def pop_to_depth(self, depth: int, next_step: int) -> "Control":
        """Fan-in hop (PopAndMerge): keep the common-prefix stack of length
        ``depth`` — identical for every peer of the fan-in by construction."""
        return Control(self.workflow_id, next_step, self.branch[:depth],
                       self.iteration)

    def next_iteration(self, back_step: int) -> "Control":
        """Cycle back-edge: re-enter the loop head with a fresh iteration."""
        return Control(self.workflow_id, back_step, self.branch,
                       self.iteration + 1)

    # ---- (de)serialization — JointλObjects travel as plain dicts ---------------

    def to_dict(self) -> dict:
        return {
            "workflowId": self.workflow_id,
            "step": self.step,
            "branch": list(self.branch),
            "iter": self.iteration,
        }

    @staticmethod
    def from_dict(d: dict) -> "Control":
        return Control(
            workflow_id=d["workflowId"],
            step=int(d.get("step", 0)),
            branch=tuple(d.get("branch", ())),
            iteration=int(d.get("iter", 0)),
        )


def aggregator_bitmap_key(workflow_id: str, agg_name: str, agg_step: int,
                          agg_branch: Sequence[int], agg_iteration: int) -> str:
    """The fan-in coordination-point key (§4.3.2): aggregator id + suffix."""
    ctl = Control(workflow_id, agg_step, tuple(agg_branch), agg_iteration)
    return ctl.function_id(agg_name) + BITMAP_SUFFIX


def collaboration_key(kind: str, member_names: Sequence[str]) -> str:
    """ByBatch / ByRedundant coordination key: *not* workflow-scoped — the
    paper concatenates the names of all functions in the sub-graph so that
    multiple workflows can meet at the same coordination point (§4.3.2)."""
    return f"__collab__/{kind}:" + "&".join(member_names)
