"""The device mesh (port of `ucf_vit_tpu/parallel/mesh.py`).

The JAX package lays every device on one named mesh, and GSPMD inserts the
collectives that logical axis names on the parameters ask for. The port
builds the same 6-axis mesh as a `torch.distributed.device_mesh.DeviceMesh`
over the processes of the job, one device each, and makes the collectives
explicit: tensor parallelism on the `tp` groups (`models/blocks.py`,
`parallel/collectives.py`), ZeRO-3 sharding on the `(ddp, fsdp)` submesh
(`parallel/train_step.py`).

Axes, outermost first (`:41-47`): pp (`pipe_par_size`), ddp
(`simple_ddp_size`), ep (`expert_par_size`), fsdp (`fsdp_size`), sp
(`seq_par_size`), tp (`tensor_par_size`). Rank r sits at the row-major
coordinates of r in that shape, as the JAX package lays CPU devices out, so
tp ranks are neighbours. The batch is split over the data axes ddp, ep and
fsdp (`DATA_AXES`): the data rank is the row-major index over them, and the
tp (and sp, pp) ranks of one data rank see the same slice.

Expert parallelism (ep > 1, `models/moe.py`): the ep ranks of one (ddp,
fsdp) coordinate hold different experts and exchange their tokens over the
ep group (`group("ep")`); everything outside the experts is data-parallel
over ep, as the JAX package lays it out (`:51-54, 76-81`). The expert leaves
are replicated over the non-ep data axes (`EXPERT_DATA_AXES`), whose group
is `expert_data_group`.

`init_distributed` joins the job from torchrun's variables (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`) or SLURM's (`SLURM_PROCID`, `SLURM_NTASKS`,
`SLURM_LOCALID`), as the JAX trainer's `init_distributed` reads SLURM's
(`ucf_vit_tpu/train.py:287-306`); it does nothing when a process group
exists already (a test or `chip_smoke.py` makes its own).

The JAX package's divisibility rule (`fit_spec_to_shape`, `:229-245`: a
dim that does not divide by its axes stays replicated) holds for tp module
by module: a block whose heads (or hidden units) do not divide by tp stays
replicated (`models/blocks.py`). Over fsdp, FSDP shards every parameter by
torch.chunk's split instead, a short or empty last shard where a dim does
not divide (UNETR's 3-class bias over fsdp 2 as [2, 1]), and the checkpoint
joins the shards back by the same split.

`mesh_context` makes a mesh the active one: the attention reads its
coordinates to fold dropout seeds, and the losses its data group.

Sequence parallelism (sp > 1) splits the token stream of each block stack
over the sp group (`models/vit.py`, `VIT._run_stack`): the stack runs
inside `sequence_context(SeqShard(...))`, which tells the attention
(`ops/attention.py`) and the element dropout (`models/blocks.py`) that the
tokens in hand are this rank's `1/sp` of the sequence. The JAX package
shards the residual stream's `seq` dim over sp where sp divides it and
leaves it replicated where it does not (`fit_spec_to_shape`); a stack whose
tokens sp does not divide runs whole on every sp rank, outside any
`sequence_context`, where its attention is EINSUM (it attends globally),
and raises where it is FLASH, as the JAX package's `shard_map` does.

UNETR's and SAP's convolutional decoders take sp as a spatial partition
(the JAX package's `_spatial`, `ucf_vit_tpu/models/unetr.py:34-46`, whose
"spatial" axis is sp's): `spatial` splits dim 2 of a channels-first map
`[B, C, s1, ...]` over sp where sp divides `s1` and leaves it whole where it
does not (`fit_spec_to_shape`), and `spatial_gather` joins a split map. The
decoder's blocks run inside `spatial_context(shard)` and are told whether
the map in hand is split (`models/unet_blocks.py`). The gradient convention
is the token stream's: a split map's gradient is its slab's true one, a
whole map's a partial sum over sp.

`eval_mesh` is the mesh that evaluation, generation and serving run on
(`ucf_vit_tpu/inference.py:49-75`): the config's, when the launch has its
processes, else None (one process evaluates the whole model, as the JAX
package falls back to one device). `gather_data` joins the data ranks'
slices of a batch's result in data-rank order.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ucf_vit_tpu_torch.parallel import collectives

AXIS_PP = "pp"
AXIS_DDP = "ddp"
AXIS_EP = "ep"
AXIS_FSDP = "fsdp"
AXIS_SP = "sp"
AXIS_TP = "tp"
MESH_AXES = (AXIS_PP, AXIS_DDP, AXIS_EP, AXIS_FSDP, AXIS_SP, AXIS_TP)
# the axes the batch is split over (`:53`)
DATA_AXES = (AXIS_DDP, AXIS_EP, AXIS_FSDP)
# the axes FSDP runs on: replicated over ddp, sharded over fsdp
FSDP_AXES = (AXIS_DDP, AXIS_FSDP)
# the data axes an expert leaf is replicated over (ep splits the experts)
EXPERT_DATA_AXES = (AXIS_DDP, AXIS_FSDP)
# the `parallelism:` axes not ported yet, with their ROADMAP.md items
REFUSED_AXES = {
    "pipe_par_size": "item 12: pipeline",
}

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("ucf_vit_tpu_torch_mesh",
                                                              default=None)
_SEQ_SHARD: contextvars.ContextVar = contextvars.ContextVar("ucf_vit_tpu_torch_seq_shard",
                                                            default=None)
_SPATIAL_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "ucf_vit_tpu_torch_spatial_shard", default=None)


class Mesh:
    """The job's DeviceMesh with the groups the port's collectives run on:
    one group per axis, `data_group` over the data axes (the ranks that
    share every other coordinate) and `expert_data_group` over the non-ep
    data axes."""

    def __init__(self, device_mesh, data_group, expert_data_group=None):
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, device_mesh.mesh.shape))
        self.coords: Dict[str, int] = dict(zip(MESH_AXES, device_mesh.get_coordinate()))
        self.data_group = data_group
        self.expert_data_group = expert_data_group

    @property
    def world(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def data_size(self) -> int:
        return int(np.prod([self.shape[a] for a in DATA_AXES]))

    @property
    def expert_data_size(self) -> int:
        return int(np.prod([self.shape[a] for a in EXPERT_DATA_AXES]))

    @property
    def data_rank(self) -> int:
        r = 0
        for a in DATA_AXES:
            r = r * self.shape[a] + self.coords[a]
        return r

    def fsdp_mesh(self):
        """The 2-D (ddp, fsdp) submesh this rank belongs to."""
        return self.device_mesh[FSDP_AXES]


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """The sp group a block stack's tokens are split over: its size and this
    rank's index in it."""

    group: object
    size: int
    rank: int


def seq_shard_of(mesh: Optional[Mesh]) -> Optional[SeqShard]:
    """The mesh's sp group as a SeqShard; None without a mesh or with sp 1."""
    if mesh is None or mesh.size(AXIS_SP) == 1:
        return None
    return SeqShard(mesh.group(AXIS_SP), mesh.size(AXIS_SP), mesh.index(AXIS_SP))


def seq_shard() -> Optional[SeqShard]:
    """The SeqShard of the block stack running now (None outside one, or
    without sp)."""
    return _SEQ_SHARD.get()


@contextlib.contextmanager
def sequence_context(shard: Optional[SeqShard]):
    """Run the block inside with `shard` as its sequence split."""
    token = _SEQ_SHARD.set(shard)
    try:
        yield
    finally:
        _SEQ_SHARD.reset(token)


def spatial_shard() -> Optional[SeqShard]:
    """The sp group of the convolutional decoder running now (None on one
    device, or outside `spatial_context`)."""
    return _SPATIAL_SHARD.get()


@contextlib.contextmanager
def spatial_context(shard: Optional[SeqShard]):
    """Run the decoder blocks inside with `shard` as the group their maps'
    first spatial dim may be split over."""
    token = _SPATIAL_SHARD.set(shard)
    try:
        yield
    finally:
        _SPATIAL_SHARD.reset(token)


def spatial(x: torch.Tensor, split: bool,
            shard: Optional[SeqShard]) -> Tuple[torch.Tensor, bool]:
    """The JAX `_spatial` rule for a channels-first map `[B, C, s1, ...]`:
    `(map, whether dim 2 is split over sp)`. `split` says whether `x` is split
    now. A whole map whose `s1` sp divides is cut into this rank's slab by
    `collectives.split` (its gradient comes back zero-padded); one that sp does
    not divide stays whole, and a split map stays split (sp divides its whole
    side by construction). Without a shard the map stays as it is."""
    if split or shard is None or x.shape[2] % shard.size:
        return x, split
    return collectives.split(x, shard.group, axis=2), True


def spatial_gather(x: torch.Tensor, split: bool, shard: Optional[SeqShard]) -> torch.Tensor:
    """The whole map of `x`: a split map's slabs joined on dim 2 in rank order
    (`all_gather`; reduce-scatter backward), a whole one as it is."""
    if not split:
        return x
    return collectives.all_gather(x, shard.group, axis=2)


def launched() -> Tuple[int, int, Optional[str]]:
    """(rank, world size, local rank or None) of this process: the process
    group's where one is up, else the launcher's environment, torchrun's
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`) or SLURM's (`SLURM_PROCID`,
    `SLURM_NTASKS`, `SLURM_LOCALID`); (0, 1, None) for a lone process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), None
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return int(env["RANK"]), int(env["WORLD_SIZE"]), env.get("LOCAL_RANK")
    if int(env.get("SLURM_NTASKS", "1")) > 1 and "SLURM_PROCID" in env:
        return int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]), env.get("SLURM_LOCALID")
    return 0, 1, None


def init_distributed(device: Optional[torch.device] = None) -> bool:
    """Join the job's process group from the launcher's environment: torchrun
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`/`MASTER_PORT`) or SLURM
    (`SLURM_PROCID`, `SLURM_NTASKS`, with `MASTER_ADDR`/`MASTER_PORT` set by
    the batch script). NCCL on CUDA, gloo on the CPU. On CUDA the process
    takes the card of its `LOCAL_RANK` (`SLURM_LOCALID`). Does nothing when
    a group exists already, or for one process; returns whether a group of
    more than one rank is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    rank, world, local = launched()
    if world <= 1:
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and local is not None:
        torch.cuda.set_device(int(local))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=30))
    return True


def make_mesh(simple_ddp_size: int = 1, fsdp_size: int = 1, seq_par_size: int = 1,
              tensor_par_size: int = 1, pipe_par_size: int = 1, expert_par_size: int = 1,
              device_type: str = "cpu") -> Mesh:
    """The 6-axis mesh over the job's processes (`:88-127`). Raises, as the
    JAX assertion does, when the product of the axes is not the world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (pipe_par_size, simple_ddp_size, expert_par_size, fsdp_size, seq_par_size,
             tensor_par_size)
    world = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if world != have:
        raise AssertionError(
            f"world size {world} (= pp {pipe_par_size} x ddp {simple_ddp_size} x "
            f"ep {expert_par_size} x fsdp {fsdp_size} x sp {seq_par_size} x "
            f"tp {tensor_par_size}) != #processes {have}")
    device_mesh = init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)
    return Mesh(device_mesh, _group_over(shape, DATA_AXES),
                _group_over(shape, EXPERT_DATA_AXES) if expert_par_size > 1 else None)


def _group_over(shape: tuple, axes: tuple):
    """This rank's group of the ranks that differ only on `axes`: one group
    for every slice of the other axes, made in the same order on every rank
    (new_group is collective over the whole job)."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    dims = [MESH_AXES.index(a) for a in axes]
    other = [d for d in range(len(shape)) if d not in dims]
    n = int(np.prod([shape[d] for d in dims]))
    me, mine = dist.get_rank(), None
    for row in ranks.transpose(other + dims).reshape(-1, n):
        g = dist.new_group(row.tolist())
        if me in row:
            mine = g
    return mine


def mesh_from_config(parallelism: dict, device_type: str = "cpu") -> Mesh:
    """The config's `parallelism:` section -> Mesh (`:184-195`)."""
    return make_mesh(
        simple_ddp_size=int(parallelism.get("simple_ddp_size", 1)),
        fsdp_size=int(parallelism.get("fsdp_size", 1)),
        seq_par_size=int(parallelism.get("seq_par_size", 1)),
        tensor_par_size=int(parallelism.get("tensor_par_size", 1)),
        pipe_par_size=int(parallelism.get("pipe_par_size", 1)),
        expert_par_size=int(parallelism.get("expert_par_size", 1)),
        device_type=device_type,
    )


def eval_mesh(cfg, device: Optional[torch.device] = None) -> Optional[Mesh]:
    """The mesh of `cfg`'s `parallelism:` for evaluation, generation and
    serving (`_eval_mesh`, `ucf_vit_tpu/inference.py:49-75`): None for a
    config of one device, and None, with the JAX package's line, for a
    launch of one process (a config trained on many devices evaluates on
    one). A launch of more (torchrun or srun) joins the job
    (`init_distributed`) and builds the config's mesh; it raises where the
    config asks for pp (not ported) or for another number of processes than
    were launched. On an ep mesh every rank runs every forward: the experts'
    all-to-all takes all of them."""
    size = int(cfg.world_size)
    if size <= 1:
        return None
    _, world, _ = launched()
    if world <= 1:
        print(f"eval: parallelism wants {size} devices, 1 available -> single-device eval",
              flush=True)
        return None
    for key, item in REFUSED_AXES.items():
        if int(cfg.parallelism.get(key, 1)) > 1:
            raise NotImplementedError(f"parallelism.{key} > 1 is not ported yet (ROADMAP.md, "
                                      f"modules to port, {item}); launch one process to "
                                      "evaluate on one device")
    if world != size:
        raise RuntimeError(
            f"parallelism {cfg.parallelism} asks for {size} processes but {world} were "
            f"launched: run it under `torchrun --nproc_per_node {size}` (or srun), or as one "
            "process to evaluate on one device")
    dev = torch.device("cuda" if device is None else device)
    init_distributed(dev)
    return mesh_from_config(cfg.parallelism, dev.type)


def gather_data(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The data ranks' slices `t` (the leading dim, equal on every data rank)
    joined in data-rank order, on every rank of the data group: the global
    batch's result (all must call). `t` itself without a mesh."""
    if mesh is None or mesh.data_size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.data_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def is_main(mesh: Optional[Mesh]) -> bool:
    """Rank 0, which alone logs and writes files (every process without a
    mesh)."""
    return mesh is None or dist.get_rank() == 0


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    """Make `mesh` the active mesh (None: single device) inside the block."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This rank's slice of a global host batch (`shard_batch`, `:314-332`):
    every array's leading dim split in `data_size` equal parts, part
    `data_rank` kept; the tp ranks of one data rank keep the same part.
    Entries that are not arrays (`variables`, trees) pass unchanged."""
    if mesh is None or mesh.data_size == 1:
        return batch
    n, r = mesh.data_size, mesh.data_rank
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
            if v.shape[0] % n:
                raise ValueError(f"batch dim {v.shape[0]} of {k!r} does not split over "
                                 f"{n} data ranks")
            m = v.shape[0] // n
            out[k] = v[r * m:(r + 1) * m]
        else:
            out[k] = v
    return out
