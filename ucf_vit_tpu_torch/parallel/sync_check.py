"""Replica-consistency check: catch parameters that silently diverged
between ranks that must hold the same values (port of
`ucf_vit_tpu/parallel/sync_check.py`).

Each rank fingerprints its local parameter shards with two f32 sums (`:81-107`):
the energy `sum x^2` and the position-sensitive `sum x * cos(0.7310586 i)`
over each leaf's flat index i, so that a permuted or shifted corruption
changes the second even when the first collides. The fingerprints of all
ranks meet in one all-reduce of a `[world, 2]` tensor. Ranks whose
coordinates agree on every mesh axis a parameter is sharded over (tp for the
tensor-parallel leaves, fsdp under FSDP) hold the same bytes when healthy:
they run the same arithmetic on the same inputs, so their fingerprints are
bit-equal, and any difference is a real divergence. The sp ranks of a
sequence-parallel run are such replicas: every one of them sums the same
partial gradients over the sp group and applies the same update. The expert
leaves of an ep mesh (`model.ep_layout`) hold different experts on each ep
rank: they are fingerprinted apart and compared within each ep index, the
other leaves across ep too. `trainer.sync_check_every:
N` runs the check every N steps and raises `ReplicaDesyncError` naming the
divergent ranks.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ucf_vit_tpu_torch.parallel.mesh import AXIS_EP, AXIS_FSDP, AXIS_TP, MESH_AXES, Mesh

_POS_FREQ = 0.7310586


class ReplicaDesyncError(RuntimeError):
    """Ranks that must hold identical parameter replicas disagree."""


@dataclasses.dataclass
class SyncReport:
    ok: bool
    # mesh axes of size > 1 along which replicas exist (no leaf is sharded there)
    redundancy_axes: Tuple[str, ...]
    n_groups: int  # replica groups compared
    # [(group coordinates, [(rank, fingerprint), ...])] for each unequal group
    mismatches: List[Tuple[Dict[str, int], List[Tuple[int, Tuple[float, ...]]]]]

    def describe(self) -> str:
        if self.ok:
            return (f"replica consistency OK: {self.n_groups} groups bit-equal across axes "
                    f"{list(self.redundancy_axes)}")
        lines = []
        for coords, ranks in self.mismatches:
            lines.append(f"  shard group {coords}: "
                         + ", ".join(f"rank {r} fp={fp}" for r, fp in ranks))
        return "replica DESYNC detected:\n" + "\n".join(lines)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def local_fingerprint(tensors) -> torch.Tensor:
    """`[energy, positional]` of this rank's local shards, f32 on their
    device."""
    t1 = t2 = None
    for t in tensors:
        x = _local(t).detach().float().reshape(-1)
        if x.numel() == 0:
            continue
        w = torch.cos(torch.arange(x.numel(), device=x.device, dtype=torch.float32)
                      * _POS_FREQ)
        a, b = torch.dot(x, x), torch.dot(x, w)
        t1, t2 = (a, b) if t1 is None else (t1 + a, t2 + b)
    if t1 is None:
        return torch.zeros(2)
    return torch.stack([t1, t2])


def used_axes(model: torch.nn.Module, mesh: Mesh) -> set:
    """The mesh axes some parameter of `model` is sharded over."""
    axes = set()
    if mesh.size(AXIS_TP) > 1 and getattr(model, "tp_layout", None):
        axes.add(AXIS_TP)
    if mesh.size(AXIS_FSDP) > 1 and any(hasattr(p, "placements") for p in model.parameters()):
        axes.add(AXIS_FSDP)
    return axes


def device_fingerprints(model: torch.nn.Module, mesh: Mesh, expert: bool = False
                        ) -> torch.Tensor:
    """Every rank's fingerprint, `[world, 2]` f32 on the CPU, on every rank: of
    the leaves other than the expert leaves, or with `expert` of those."""
    ep = getattr(model, "ep_layout", set())
    fp = local_fingerprint(p for n, p in model.named_parameters() if (n in ep) == expert)
    dev = next(model.parameters()).device
    table = torch.zeros(mesh.world, 2, dtype=torch.float32, device=dev)
    table[dist.get_rank()] = fp.to(dev)
    dist.all_reduce(table)  # one rank's row is nonzero in each: the sum is exact
    return table.cpu()


def _compare(fps: torch.Tensor, used: set, shape: list, mismatches: list) -> int:
    """Group the ranks by their coordinates on `used` and append each group
    whose fingerprints differ to `mismatches`; returns the number of groups."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for rank, coords in enumerate(itertools.product(*[range(n) for n in shape])):
        key = tuple(c for c, a in zip(coords, MESH_AXES) if a in used)
        groups.setdefault(key, []).append(rank)
    for key, ranks in groups.items():
        ref = fps[ranks[0]]
        if all(torch.equal(fps[r], ref) for r in ranks[1:]):
            continue
        coords = dict(zip([a for a in MESH_AXES if a in used], key))
        mismatches.append((coords, [(r, tuple(float(v) for v in fps[r])) for r in ranks]))
    return len(groups)


def check_replica_consistency(model: torch.nn.Module, mesh: Mesh,
                              raise_on_mismatch: bool = True) -> SyncReport:
    """Compare the fingerprints of ranks that must be byte-identical; every
    rank must call it together."""
    used = used_axes(model, mesh)
    shape = [mesh.size(a) for a in MESH_AXES]
    redundancy = tuple(a for a, n in zip(MESH_AXES, shape) if n > 1 and a not in used)
    mismatches: list = []
    n_groups = _compare(device_fingerprints(model, mesh), used, shape, mismatches)
    if getattr(model, "ep_layout", None) and mesh.size(AXIS_EP) > 1:
        n_groups += _compare(device_fingerprints(model, mesh, expert=True), used | {AXIS_EP},
                             shape, mismatches)
    report = SyncReport(ok=not mismatches, redundancy_axes=redundancy, n_groups=n_groups,
                        mismatches=mismatches)
    if mismatches and raise_on_mismatch:
        raise ReplicaDesyncError(report.describe())
    return report
