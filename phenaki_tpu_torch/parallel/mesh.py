"""Process mesh and parameter placement rules (counterpart of
phenaki_tpu/parallel/mesh.py).

JAX lays a `Mesh` of devices out over named axes and lets one program run on
all of them. Here every rank is a process of one `torch.distributed` group,
and a `Mesh` is that group laid out over named axes: the ranks in row-major
order over ('dp', 'tp') (`make_mesh`), or ('dcn', 'dp', 'tp') with the nodes
on 'dcn' (`make_multislice_mesh`). For each axis (and for the data axes
together) the mesh holds the process groups of the ranks that differ only
on it: `mesh.group("tp")` is this rank's tensor-parallel group,
`mesh.group("pp")` its pipeline's ring of stages, `mesh.data_group` its
data-parallel one. `make_mesh(pp=)` adds the 'pp' axis last, ('dp', 'tp',
'pp'), with the ranks in JAX's row-major order. A group of one is None, and every
collective of the port treats None as the identity, so one code path serves
any mesh, the 1 x 1 mesh of a single process included.

The placement rules are data, as in the JAX package: a parameter's name (the
port's `state_dict` name) and shape give its placement, a tuple of one entry
a dim, "tp", "dp" or None (`param_partition_spec`). The TP rules are
Megatron's: q/kv and the GEGLU input are column-parallel, the attention and
FF outputs row-parallel, the vocab head column-parallel, the embeddings
replicated; they are the JAX rules on the port's layout (a Linear weight is
(out, in), the transpose of a flax kernel). FSDP shards a parameter of at
least 2**16 elements on its largest dim that divides by the data axis and
holds no "tp", ties going to the dim that comes first in the JAX layout (on
a pipeline mesh a trunk layer's parameter counts its whole stack of layers,
as JAX's scanned leaf does: `fsdp.fsdp_shard_dim`).
The manual tensor parallelism of the port (`tp_inference`) and its FSDP
(`fsdp_shard_dim`) read these rules. The pipeline's rule (`pipeline_stage`)
names the stage that holds a trunk layer: layer i of a trunk of `depth`
layers belongs to stage i // (depth / pp) when pp divides the depth (JAX
shards the stacked depth axis so); every other parameter is on every stage.
`stage_layers` lists a stage's layers by that rule, and the pipeline builds
a rank's stage from it. It composes with the TP rules: a stage holds its tp
rank's shards of its layers (`parallel/pipeline.py`).
"""

from __future__ import annotations

import os
import re
import socket
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from phenaki_tpu_torch.parallel import collectives

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
PIPE_AXIS = "pp"

# FSDP: parameters below this many elements stay replicated (JAX's minimum)
FSDP_MIN_SIZE = 2**16

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A process group laid out over named axes.

    `ranks` is an integer array whose axes are `axis_names`: entry
    [i, j, ...] is the global rank at those coordinates. `shape` maps each
    axis to its size; `coords` this rank's coordinates. Build it with
    `make_mesh` or `make_multislice_mesh`, on every rank of the group (the
    process groups are created collectively)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a mesh of rank {ranks.ndim} needs as many axis names, got {axis_names}")
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh {ranks.tolist()}")
        self.coords: Dict[str, int] = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self.data_axes = tuple(a for a in ("dcn", DATA_AXIS) if a in self.shape)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        combos = [(a,) for a in self.axis_names]
        if len(self.data_axes) > 1:
            combos.append(self.data_axes)
        for axes in combos:  # every rank creates every group, in this order
            self._groups[axes] = self._make_groups(axes)
        self._device_meshes: Dict[Tuple[Tuple[str, ...], str], Any] = {}

    def _make_groups(self, axes: Tuple[str, ...]):
        """The group of the ranks that share this rank's coordinates on every
        axis but `axes`; None when that group has one rank."""
        if int(np.prod([self.shape[a] for a in axes])) == 1:
            return None
        moved = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.ranks.ndim) if i not in moved]
        table = np.transpose(self.ranks, rest + moved).reshape(-1, int(np.prod([self.shape[a] for a in axes])))
        mine = None
        for row in table:
            g = dist.new_group([int(r) for r in row])
            if self.rank in row:
                mine = g
        return mine

    def group(self, *axes: str):
        """The process group over `axes` (None for a group of one)."""
        return self._groups[tuple(axes)]

    @property
    def tp(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def dp_index(self) -> int:
        return self.coords.get(DATA_AXIS, 0)

    @property
    def tp_index(self) -> int:
        return self.coords.get(MODEL_AXIS, 0)

    @property
    def tp_group(self):
        return self.group(MODEL_AXIS) if MODEL_AXIS in self.shape else None

    @property
    def pp(self) -> int:
        return self.shape.get(PIPE_AXIS, 1)

    @property
    def pp_index(self) -> int:
        return self.coords.get(PIPE_AXIS, 0)

    @property
    def pp_group(self):
        return self.group(PIPE_AXIS) if PIPE_AXIS in self.shape else None

    @property
    def data_size(self) -> int:
        """The batch's shards: the product of the data axes ('dcn', 'dp')."""
        return int(np.prod([self.shape[a] for a in self.data_axes]))

    @property
    def data_index(self) -> int:
        """This rank's shard of the batch over the data axes, row-major."""
        index = 0
        for a in self.data_axes:
            index = index * self.shape[a] + self.coords[a]
        return index

    @property
    def data_group(self):
        return self.group(*self.data_axes) if self.data_axes else None

    @property
    def world_group(self):
        """The group of every rank of the mesh (the default group), or None
        for a single process."""
        return dist.group.WORLD if self.size > 1 else None

    def device_mesh(self, axes: Tuple[str, ...], device_type: str):
        """A 1-D `DeviceMesh` over this rank's group on `axes`, for FSDP."""
        key = (axes, device_type)
        if key not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_meshes[key] = DeviceMesh.from_group(self.group(*axes), device_type)
        return self._device_meshes[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(dp: Optional[int] = None, tp: int = 1, pp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over the default process group (the ranks in
    row-major order: rank = dp_index * tp + tp_index), or with `pp > 1` a
    ('dp', 'tp', 'pp') one (rank = (dp_index * tp + tp_index) * pp +
    pp_index). `dp` defaults to world / (tp * pp). A single process without
    a group makes the 1 x 1 mesh."""
    world = _world()
    if tp < 1 or pp < 1:
        raise ValueError(f"tp ({tp}) and pp ({pp}) must be positive")
    if dp is None:
        if world % (tp * pp):
            raise ValueError(f"tp ({tp}) * pp ({pp}) does not divide the world size ({world})")
        dp = world // (tp * pp)
    if dp * tp * pp != world:
        raise ValueError(f"dp ({dp}) * tp ({tp}) * pp ({pp}) != world size ({world}); "
                         "init_distributed joins the process group first")
    if pp > 1:
        return Mesh(np.arange(world).reshape(dp, tp, pp), (DATA_AXIS, MODEL_AXIS, PIPE_AXIS))
    return Mesh(np.arange(world).reshape(dp, tp), (DATA_AXIS, MODEL_AXIS))


def _node_of_each_rank() -> list:
    """A node key for every rank: consecutive blocks of LOCAL_WORLD_SIZE
    ranks (as torchrun numbers them), else the ranks' host names."""
    world = _world()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local and int(local) > 0 and world % int(local) == 0:
        return [r // int(local) for r in range(world)]
    if world == 1:
        return [0]
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return names


def make_multislice_mesh(tp: int = 1) -> Mesh:
    """A ('dcn', 'dp', 'tp') mesh: the nodes on 'dcn' (the gradient
    all-reduce is the only collective that crosses them), dp and tp within a
    node. Nodes come from LOCAL_WORLD_SIZE or the hosts' names; every node
    must hold as many ranks. One node when neither tells more."""
    nodes = _node_of_each_rank()
    order = list(dict.fromkeys(nodes))
    by_node = [[r for r, n in enumerate(nodes) if n == key] for key in order]
    per = len(by_node[0])
    if any(len(b) != per for b in by_node):
        raise ValueError(f"nodes hold unequal rank counts: {[len(b) for b in by_node]}")
    if per % tp:
        raise ValueError(f"ranks a node ({per}) % tp ({tp}) != 0")
    return Mesh(np.asarray(by_node).reshape(len(by_node), per // tp, tp), ("dcn", DATA_AXIS, MODEL_AXIS))


# parameter placement rules

# (regex over the port's parameter name, placement of a Linear weight
# (out, in) or an embedding (rows, dim)); everything else is replicated
TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*(to_q|to_kv)\.weight$", (MODEL_AXIS, None)),
    (r".*proj_in\.weight$", (MODEL_AXIS, None)),  # FF in (GEGLU)
    (r".*to_out\.weight$", (None, MODEL_AXIS)),
    (r".*proj_out\.weight$", (None, MODEL_AXIS)),  # FF out
    (r".*to_logits\.weight$", (MODEL_AXIS, None)),  # vocab-parallel head
    (r".*token_emb\.weight$", (None, None)),
    (r".*pos_emb\.weight$", (None, None)),
)

_EMBEDDING = re.compile(r".*_emb\.weight$")

# a layer of a MaskGit's or TokenCritic's trunk (the module named `transformer`;
# the C-ViViT's stacks are named otherwise and are not pipelined)
TRUNK_LAYER = re.compile(r"^(?:.*\.)?transformer\.layers\.(\d+)\.")


def pipeline_stage(name: str, depth: int, pp: int) -> Optional[int]:
    """The pipeline stage that holds parameter `name` of a model whose trunk
    has `depth` layers, over `pp` stages: layer i's parameters belong to
    stage i // (depth / pp); None (every stage holds it) for a parameter
    outside the trunk's layers, or when pp does not divide the depth (JAX
    then leaves the stacked layers replicated)."""
    m = TRUNK_LAYER.match(name)
    if m is None or pp <= 1 or depth % pp:
        return None
    return int(m.group(1)) // (depth // pp)


def stage_layers(depth: int, pp: int, stage: int) -> range:
    """The global indices of the trunk layers that stage `stage` of `pp`
    holds, by `pipeline_stage` (every layer when pp = 1)."""
    if depth % pp:
        raise ValueError(f"the trunk's depth ({depth}) does not divide by pp ({pp})")
    own = [i for i in range(depth) if (pipeline_stage(f"transformer.layers.{i}.", depth, pp) or 0) == stage]
    return range(own[0], own[-1] + 1)


def jax_dim_order(name: str, ndim: int) -> Tuple[int, ...]:
    """The port's dims in the order of the JAX layout's (the bridge's
    layout rules read backwards): a Linear weight (out, in) is a kernel
    (in, out), a Conv2d weight (out, in, kh, kw) one (kh, kw, in, out), the
    PEG's depthwise Conv3d weight (d, 1, 3, 3, 3) one (3, 3, 3, 1, d)."""
    if name.endswith(".weight") and not _EMBEDDING.match(name):
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)
        if ndim == 5:
            return (2, 3, 4, 1, 0)
    return tuple(range(ndim))


def param_partition_spec(name: str, shape: Sequence[int], tp_enabled: bool = True,
                         fsdp_size: int = 1) -> Spec:
    """The placement of one parameter from its name and shape: one entry a
    dim, MODEL_AXIS where the TP rules shard it, DATA_AXIS where FSDP
    (`fsdp_size` > 1) does, None elsewhere. Divisibility by tp is left to
    where the placement is applied, as in the JAX package."""
    ndim = len(shape)
    spec: list = [None] * ndim
    if tp_enabled:
        for pattern, tp_spec in TP_RULES:
            if re.match(pattern, name) and len(tp_spec) == ndim:
                spec = list(tp_spec)
                break
    if fsdp_size > 1 and ndim >= 1 and int(np.prod(shape)) >= FSDP_MIN_SIZE:
        cands = [i for i in jax_dim_order(name, ndim) if spec[i] is None and shape[i] % fsdp_size == 0]
        if cands:
            spec[max(cands, key=lambda i: shape[i])] = DATA_AXIS  # max keeps the first of a tie
    return tuple(spec)


# batches and placement


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous slice of a global batch over the data axes
    (rows [i * b / n, (i + 1) * b / n) of data shard i of n); a leaf whose
    leading axis does not divide stays whole (replicated), as in the JAX
    package. Tensors and arrays are leaves; lists, tuples and dicts are
    walked; anything else is returned as it is."""
    n, i = mesh.data_size, mesh.data_index

    def place(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if x.ndim >= 1 and x.shape[0] % n == 0:
                rows = x.shape[0] // n
                return x[i * rows:(i + 1) * rows]
            return x
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not (x and all(isinstance(s, str) for s in x)):
            return type(x)(place(v) for v in x)
        return x

    return place(batch) if n > 1 else batch


@torch.no_grad()
def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values on every rank of the mesh: each tensor of the tree is
    broadcast in place (and returned); other leaves as they are."""
    group = mesh.world_group
    if group is None:
        return tree
    if isinstance(tree, torch.Tensor):
        tree.copy_(collectives.broadcast_object(tree.detach().cpu(), group))
        return tree
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def place_like(template: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor], mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """Each global tensor of `values` as this rank holds it where `template`
    (a tensor-parallel module's `state_dict`, possibly FSDP-sharded, on this
    rank) holds the same name: packed and sliced for the rank's tp shard
    (`tp_inference.tp_state_dict`), then cut to this rank's FSDP shard where
    the template's tensor is one, on the template's device and dtype."""
    from phenaki_tpu_torch.parallel.tp_inference import local_value

    return {name: local_value(name, values[name], t, mesh) for name, t in template.items()}
