"""The (data, model) mesh as processes (counterpart of
``scan2cap_tpu/parallel/mesh.py``).

In the JAX package a mesh changes only the layout of one program: XLA
inserts the collectives.  Here ``--mesh DATA,MODEL`` starts DATA x MODEL
ranks, one process each, and this module writes those collectives
itself, over ``torch.distributed`` (NCCL on the card, gloo on the CPU).

Layout.  Rank = d * MODEL + m, row-major, as ``make_mesh`` reshapes its
devices.  The ranks with one model index m form a data group; the ranks
with one data index d form a model group.  Rank (d, m) holds rows
[d * B / DATA, (d + 1) * B / DATA) of the global batch of B scenes.

What keeps the single-process function:

- Batch-wide ratios.  A loss that divides one sum over the batch by
  another keeps its numerator local and takes its denominator over the
  data group (``batch_sum``, no autograd): each rank computes its share of
  the global loss, and the shares add up to it.  Gradients are SUMMED over
  the data group (``sum_gradients``), and so are the reported metrics.
- Train-mode BatchNorm takes its mean and variance over the global batch
  (``sum_shares``: the sums travel with autograd in both directions).
- The model axis splits the caption classifier's vocabulary columns
  (its hidden rows where the width does not divide) and the hidden axis
  of ``map_feat`` and ``map_hidd`` (``caption_splits``); every other
  parameter is replicated.  A replicated tensor that enters a split
  computation goes through ``enter`` (identity; its gradient is summed
  over the model group), partial sums through ``psum`` and split outputs
  through ``gather`` (its gradient is the rank's own slice).
- Eval pads an uneven batch by repeating its last scene
  (``mesh_eval_fn``), and the caption decode splits its targets over the
  model group (``decode_split``).
- Rank 0 logs and writes; a checkpoint holds whole tensors
  (``full_state_dict``, ``full_optimizer_state``) and restores into any
  mesh shape (``shard_state_dict``, ``shard_optimizer_state``).

A group of one rank issues no collective: its all-reduce and all-gather
return a detached contiguous copy of their input without calling
``torch.distributed``, as XLA emits no collective on a mesh axis of size
1.  Every other collective is issued, and none is skipped or caught.
``COLLECTIVES`` counts the calls issued by axis and ``COLLECTIVE_BYTES``
the bytes they deliver to each rank (an all-reduce's tensor, an
all-gather's concatenation: the output bytes that the JAX package's
``__graft_entry__._collective_bytes`` reads off the HLO).  Each issued
all-reduce and all-gather opens a ``scan2cap.collective`` span while a
profiler runs (``utils/profiling.annotate``).

The entry points start the ranks themselves (``launch``); the process
group is initialised through a ``FileStore`` in a temporary directory, so
no port is picked.  A rank that fails ends every rank.  Inside one running
group, ``sub_mesh`` builds a mesh of another shape over its first ranks
(``scripts/dryrun_multicard`` holds several shapes in one launch).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import math
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from scan2cap_torch.utils.profiling import annotate

# the "devices" a CPU mesh may use, as the JAX package's tests force 8
# virtual CPU devices (tests/conftest.py)
CPU_DEVICES = 8
# keys of a batch that every rank holds whole (mesh.py _REPLICATED_KEYS)
REPLICATED_KEYS = frozenset({"glove_emb_table"})
# collectives issued, and the bytes they delivered to this rank, by axis
# ("data", "model" or "world"); an object broadcast (``main_only``) counts
# as a call only
COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The shape of a mesh before its ranks start."""
    n_data: int
    n_model: int

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def device_count(device: str | torch.device) -> int:
    """The devices a mesh on ``device`` may use: the CUDA devices present,
    or ``CPU_DEVICES`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return CPU_DEVICES


def parse_mesh(spec: str, device: str | torch.device = "cuda",
               n_devices: Optional[int] = None) -> MeshSpec:
    """``--mesh DATA,MODEL`` (``DATA`` alone means ``DATA,1``).  Fails
    loudly when the mesh needs more devices than ``n_devices`` (default
    ``device_count(device)``): no mesh falls back to a smaller one."""
    parts = [int(x) for x in spec.split(",")]
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2 or min(parts) < 1:
        raise ValueError(f"--mesh expects DATA,MODEL with both >= 1; "
                         f"got {spec!r}")
    n_data, n_model = parts
    if n_devices is None:
        n_devices = device_count(device)
    if n_data * n_model > n_devices:
        raise ValueError(
            f"--mesh {spec} needs {n_data * n_model} devices; only "
            f"{n_devices} available ({torch.device(device).type})")
    return MeshSpec(n_data, n_model)


def setup_mesh(spec: str, batch_size: int,
               device: str | torch.device = "cuda",
               n_devices: Optional[int] = None) -> MeshSpec:
    """The trainers' front door for ``--mesh``: parse it, and check that
    the data axis divides the batch size.  Raises SystemExit with the
    user-facing message."""
    try:
        mesh = parse_mesh(spec, device, n_devices)
    except ValueError as e:
        raise SystemExit(str(e))
    if batch_size % mesh.n_data != 0:
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the mesh "
            f"data axis ({mesh.n_data})")
    return mesh


def padded_vocab(num_vocabs: int, n_model: int, multiple: int = 128) -> int:
    """Smallest vocabulary width >= ``num_vocabs`` divisible by both
    ``n_model`` and ``multiple``: the classifier's vocabulary columns then
    split evenly over the model axis.  The pad columns are masked to -1e30
    (``models/caption._mask_pad_logits``), so real token ids keep the
    single-process semantics."""
    step = math.lcm(max(n_model, 1), max(multiple, 1))
    return -(-num_vocabs // step) * step


class Mesh:
    """One rank's view of the mesh: its indices and its groups."""

    def __init__(self, spec: MeshSpec, rank: int, device: torch.device,
                 data_group, model_group, world_group=None):
        self.spec = spec
        self.n_data, self.n_model = spec.n_data, spec.n_model
        self.rank = rank
        self.d, self.m = divmod(rank, spec.n_model)
        self.device = device
        self.groups = {"data": data_group, "model": model_group,
                       "world": world_group or dist.group.WORLD}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def size(self, axis: str) -> int:
        return {"data": self.n_data, "model": self.n_model,
                "world": self.spec.size}[axis]

    def index(self, axis: str) -> int:
        return {"data": self.d, "model": self.m, "world": self.rank}[axis]


_CURRENT: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """This process's mesh, or None outside a mesh run."""
    return _CURRENT


def is_main() -> bool:
    """True outside a mesh run and on rank 0."""
    return _CURRENT is None or _CURRENT.is_main


def _require() -> Mesh:
    if _CURRENT is None:
        raise RuntimeError("no mesh: this runs inside a rank of launch()")
    return _CURRENT


def init_rank(spec: MeshSpec, rank: int, device: str | torch.device,
              store_path: str) -> Mesh:
    """Join the process group (NCCL on ``cuda:<rank>``, gloo on the CPU)
    through a FileStore at ``store_path``, build the data and model
    groups, and make the mesh current."""
    global _CURRENT
    dev = torch.device(device)
    if dev.type == "cuda":
        # one host: the local rank is the rank
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        backend = "nccl"
    else:
        backend = "gloo"
    store = dist.FileStore(store_path, spec.size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=spec.size,
                            timeout=datetime.timedelta(hours=2))
    _CURRENT = _build_mesh(spec, rank, dev)
    return _CURRENT


def _build_mesh(spec: MeshSpec, rank: int, device: torch.device
                ) -> Optional[Mesh]:
    """The groups of ``spec`` over ranks 0 .. spec.size - 1 of the running
    process group; every rank of it builds every group, in the same
    order.  This rank's mesh, or None when the mesh leaves it out."""
    D, M = spec.n_data, spec.n_model
    world = dist.get_world_size()
    if spec.size > world:
        raise ValueError(f"a ({D}, {M}) mesh needs {spec.size} ranks; the "
                         f"process group has {world}")
    data_group = model_group = None
    for m in range(M):
        g = dist.new_group([d * M + m for d in range(D)])
        if rank % M == m:
            data_group = g
    for d in range(D):
        g = dist.new_group([d * M + m for m in range(M)])
        if rank // M == d:
            model_group = g
    world_group = (None if spec.size == world
                   else dist.new_group(list(range(spec.size))))
    if rank >= spec.size:
        return None
    return Mesh(spec, rank, device, data_group, model_group, world_group)


def sub_mesh(spec: MeshSpec) -> Optional[Mesh]:
    """A mesh of shape ``spec`` over the first ``spec.size`` ranks of the
    current one's process group (every rank of it calls this, in the same
    order); this rank's view, or None on a rank the mesh leaves out.
    Make it current with ``using``."""
    mesh = _require()
    return _build_mesh(spec, dist.get_rank(), mesh.device)


@contextlib.contextmanager
def using(mesh: Optional[Mesh]):
    """``mesh`` (a ``sub_mesh``) as the current mesh while the block
    runs."""
    global _CURRENT
    saved, _CURRENT = _CURRENT, mesh
    try:
        yield mesh
    finally:
        _CURRENT = saved


@contextlib.contextmanager
def joined(spec: MeshSpec, rank: int, device: str | torch.device,
           store_path: str):
    """This process as rank ``rank`` of the mesh while the block runs
    (``init_rank``); the process group is destroyed after it."""
    global _CURRENT
    init_rank(spec, rank, device, store_path)
    try:
        yield _CURRENT
    finally:
        dist.destroy_process_group()
        _CURRENT = None


def _rank_main(rank: int, spec: MeshSpec, device: str, workdir: str,
               fn: Callable, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        # ranks share the cores: one torch thread each
        torch.set_num_threads(1)
    with joined(spec, rank, device, os.path.join(workdir, "store")):
        try:
            result = fn(*args)
            if rank == 0 and result is not None:
                torch.save(result, os.path.join(workdir, "result.pt"))
            barrier()
        except SystemExit as e:
            # the entry point's own exit (a CLI check): launch() raises it
            torch.save(e.code, os.path.join(workdir, f"exit{rank}.pt"))
            raise


def launch(spec: MeshSpec, device: str | torch.device, fn: Callable,
           *args):
    """Run ``fn(*args)`` on every rank of ``spec`` (spawned processes) and
    return rank 0's result.  A rank that raises ends every rank, and the
    error (with the failing rank's traceback) is raised here; a rank's
    SystemExit is raised here as it is."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="scan2cap_mesh_") as workdir:
        try:
            mp.start_processes(_rank_main,
                               args=(spec, str(device), workdir, fn, args),
                               nprocs=spec.size, join=True,
                               start_method="spawn")
        except mp.ProcessExitedException as e:
            code = os.path.join(workdir, f"exit{e.error_index}.pt")
            if os.path.exists(code):
                raise SystemExit(torch.load(code, weights_only=False))
            raise
        path = os.path.join(workdir, "result.pt")
        if os.path.exists(path):
            return torch.load(path, weights_only=False)
        return None


# ---------------------------------------------------------------- collectives
def _alone(mesh: Mesh, axis: str) -> bool:
    """True when this rank is the only one in the group of ``axis``: a
    collective over it is the identity and is not issued."""
    return mesh.size(axis) == 1


def _issued(axis: str, out: torch.Tensor) -> None:
    COLLECTIVES[axis] += 1
    COLLECTIVE_BYTES[axis] += out.numel() * out.element_size()


def all_reduce(x: torch.Tensor, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over the group of ``axis`` (no autograd)."""
    mesh = _require()
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if _alone(mesh, axis):
        return y
    _issued(axis, y)
    with annotate("scan2cap.collective"):
        dist.all_reduce(y, op=op, group=mesh.groups[axis])
    return y


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of the group of ``axis`` concatenated along
    ``dim`` in rank order (no autograd).  Every rank's ``x`` has the same
    shape."""
    mesh = _require()
    src = x.detach()
    if _alone(mesh, axis):
        return src.clone(memory_format=torch.contiguous_format)
    wire = src.to(torch.uint8) if src.dtype == torch.bool else src
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size(axis))]
    with annotate("scan2cap.collective"):
        dist.all_gather(parts, wire, group=mesh.groups[axis])
    out = torch.cat(parts, dim=dim)
    _issued(axis, out)
    return out.to(torch.bool) if src.dtype == torch.bool else out


def shard_of(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``dim`` over the group of ``axis``
    (the length divides the group's size)."""
    mesh = _require()
    n = mesh.size(axis)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * size, size)


class _Enter(torch.autograd.Function):
    """Identity; the gradient is summed over the group (a replicated
    tensor that enters a computation split over the group)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _Psum(torch.autograd.Function):
    """Sum over the group; the gradient passes as it is (the partial sums
    of one replicated result, counted once)."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShares(torch.autograd.Function):
    """Sum over the group, and the gradient summed too: each rank's loss
    share depends on the sum, so a rank's part gets every share's
    gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the gradient is the rank's own slice of
    the incoming one (everything downstream is replicated over the
    group)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return shard_of(g, ctx.axis, ctx.dim).contiguous(), None, None


def enter(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    return _Enter.apply(x, axis)


def psum(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    return _Psum.apply(x, axis)


def sum_shares(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    return _SumShares.apply(x, axis)


def gather(x: torch.Tensor, axis: str = "model", dim: int = -1
           ) -> torch.Tensor:
    return _Gather.apply(x, axis, dim % x.dim())


# ------------------------------------------------------- batch-wide quantities
def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a sum over this rank's rows) summed over the data group,
    without a gradient; ``x`` itself outside a mesh."""
    return x if _CURRENT is None else all_reduce(x, "data")


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """The batch-wide maximum of ``x`` (this rank's maximum)."""
    return x if _CURRENT is None else all_reduce(x, "data",
                                                 dist.ReduceOp.MAX)


def batch_count(n: int) -> int:
    """A count over this rank's rows -> over the global batch (every rank
    of the data group holds as many rows)."""
    return n if _CURRENT is None else n * _CURRENT.n_data


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch."""
    return torch.sum(x) / batch_count(x.numel())


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d metric (a rank's share) summed over the data group, in one
    collective."""
    if _CURRENT is None or not metrics:
        return metrics
    keys = list(metrics)
    total = all_reduce(torch.stack([metrics[k].float() for k in keys]),
                       "data")
    return {k: total[i] for i, k in enumerate(keys)}


def sum_gradients(params: Sequence[torch.Tensor]) -> None:
    """Sum every parameter's gradient over the data group, in one
    collective over a flat buffer."""
    if _CURRENT is None:
        return
    grads = [p.grad for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), "data")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------------- rows
def _rows(n: int, parts: int, index: int, device) -> torch.Tensor:
    """Rows of a rank's share when ``n`` splits into ``parts`` shares of
    ceil(n / parts): past the end, the last row repeats."""
    per = -(-n // parts)
    return torch.arange(index * per, (index + 1) * per,
                        device=device).clamp(max=n - 1)


def local_rows(batch: Dict) -> Dict:
    """This rank's rows of a global training batch (B divisible by the
    data axis); replicated keys and scalars stay whole."""
    mesh = current()
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        if k in REPLICATED_KEYS or v.ndim == 0:
            out[k] = v
            continue
        per = v.shape[0] // mesh.n_data
        out[k] = v[mesh.d * per:(mesh.d + 1) * per]
    return out


def mesh_eval_fn(eval_step: Callable[[Dict], Dict]) -> Callable[[Dict], Dict]:
    """Wrap ``eval_step(batch) -> dict`` for the mesh: the scene axis of
    the global batch is padded up to a multiple of the data axis by
    repeating the last scene, each rank runs its rows, and every rank gets
    the per-scene outputs of the whole batch, the padding cut off.  Exact:
    every per-scene output is a function of its scene and eval-mode BN
    uses the running statistics, so pad scenes touch no real one.

    The eval step names its outputs: ``eval_step.per_scene_outputs``
    (``train.step.make_eval_step`` names the keys it keeps) and, where it
    has any, ``eval_step.replicated_outputs``.  Only the per-scene ones
    are gathered over the data group and cut; a tensor output whose
    leading axis is a rank's scene count and that is neither per scene nor
    replicated raises, since its length alone cannot say whether it is per
    scene."""
    per_scene = getattr(eval_step, "per_scene_outputs", None)
    if per_scene is None:
        raise TypeError("mesh_eval_fn: the eval step names no "
                        "per_scene_outputs")
    per_scene = frozenset(per_scene)
    replicated = frozenset(getattr(eval_step, "replicated_outputs", ()))

    def wrapped(batch: Dict) -> Dict:
        mesh = current()
        if mesh is None:
            return eval_step(batch)
        sizes = {v.shape[0] for k, v in batch.items()
                 if k not in REPLICATED_KEYS and torch.is_tensor(v)
                 and v.dim() > 0}
        assert len(sizes) == 1, f"inconsistent batch leading axes: {sizes}"
        n = sizes.pop()
        local = {}
        for k, v in batch.items():
            if k in REPLICATED_KEYS or not torch.is_tensor(v) or v.dim() == 0:
                local[k] = v
            else:
                rows = _rows(n, mesh.n_data, mesh.d, v.device)
                local[k] = v.index_select(0, rows)
        per = -(-n // mesh.n_data)
        out = eval_step(local)
        # every key checked before any collective, so that all ranks raise
        # alike
        for k, v in out.items():
            leading = v.shape[0] if torch.is_tensor(v) and v.dim() else None
            if k in per_scene and leading != per:
                raise ValueError(f"mesh_eval_fn: per-scene output {k!r} "
                                 f"has leading axis {leading}, not this "
                                 f"rank's {per} scenes")
            if k not in per_scene | replicated and leading == per:
                raise ValueError(f"mesh_eval_fn: output {k!r} has a leading "
                                 f"axis of {per}, a rank's scene count, "
                                 f"and is declared neither per scene nor "
                                 f"replicated")
        return {k: all_gather(v, "data", 0)[:n] if k in per_scene else v
                for k, v in out.items()}

    return wrapped


def decode_split(fn: Callable, targets: Sequence[Optional[torch.Tensor]],
                 axis: str = "model") -> tuple:
    """Decode this rank's share of the targets over the group of ``axis``:
    ``fn(*shares)`` gets axis 1 of each tensor of ``targets`` cut to the
    rank's contiguous share (None passes), and returns a tuple of tensors
    with that axis; the shares are gathered back in order.  Outside a mesh
    ``fn(*targets)``."""
    mesh = current()
    if mesh is None:
        return fn(*targets)
    first = next(t for t in targets if t is not None)
    n = first.shape[1]
    rows = _rows(n, mesh.size(axis), mesh.index(axis), first.device)
    outs = fn(*[None if t is None else t.index_select(1, rows)
                for t in targets])
    return tuple(all_gather(o, axis, 1)[:, :n] for o in outs)


def main_only(fn: Callable, *args):
    """``fn(*args)`` on rank 0, its result handed to every rank."""
    mesh = current()
    if mesh is None or _alone(mesh, "world"):
        return fn(*args)
    box = [fn(*args) if mesh.is_main else None]
    COLLECTIVES["world"] += 1
    dist.broadcast_object_list(box, src=0, group=mesh.groups["world"])
    return box[0]


def barrier() -> None:
    """Wait for every rank of the mesh (none to wait for alone).  NCCL is
    told this rank's card, which it would otherwise guess from the
    rank."""
    mesh = _require()
    if _alone(mesh, "world"):
        return
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    dist.barrier(group=mesh.groups["world"], device_ids=ids)


def every_rank(obj):
    """Every rank's ``obj`` (picklable), in rank order, on every rank of
    the mesh (a collective outside the counts: for reports after the
    steps); ``[obj]`` outside a mesh."""
    mesh = current()
    if mesh is None or _alone(mesh, "world"):
        return [obj]
    out = [None] * mesh.spec.size
    dist.all_gather_object(out, obj, group=mesh.groups["world"])
    return out


# ----------------------------------------------- the caption's model axis
def caption_splits(caption: torch.nn.Module, n_model: int) -> Dict[str, int]:
    """Which of a caption module's linears split over the model axis, and
    along which dim of the torch weight (out, in): the classifier's
    vocabulary (dim 0) when its width divides the axis, else its hidden
    rows (dim 1); ``map_feat`` and ``map_hidd`` along their hidden output
    (dim 0) when it divides (``caption_param_spec``)."""
    splits = {}
    V, H = caption.classifier.weight.shape
    if V % n_model == 0:
        splits["classifier"] = 0
    elif H % n_model == 0:
        splits["classifier"] = 1
    for name in ("map_feat", "map_hidd"):
        lin = getattr(caption, name, None)
        if lin is not None and lin.weight.shape[0] % n_model == 0:
            splits[name] = 0
    return splits


def shard_model(model: torch.nn.Module) -> torch.nn.Module:
    """Keep only this rank's shard of the caption parameters that split
    over the model axis (``caption_splits``); every other parameter stays
    replicated.  Records ``model.shard_dims`` (parameter name -> the split
    dim) and the caption module's ``tp`` (linear name -> dim).  Call it
    before the optimizer is built."""
    mesh = _require()
    model.shard_dims = {}
    cap = getattr(model, "caption", None)
    if cap is None:
        return model
    splits = caption_splits(cap, mesh.n_model)
    for name, dim in splits.items():
        lin = getattr(cap, name)
        shard = shard_of(lin.weight.detach(), "model", dim).clone()
        lin.weight = torch.nn.Parameter(shard)
        model.shard_dims[f"caption.{name}.weight"] = dim
    cap.tp = splits
    return model


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict on the CPU with whole tensors: the shards of
    a split parameter gathered over the model group (a collective)."""
    dims = getattr(model, "shard_dims", {})
    out = {}
    for k, v in model.state_dict().items():
        if k in dims:
            v = all_gather(v, "model", dims[k])
        out[k] = v.detach().cpu()
    return out


def shard_state_dict(model: torch.nn.Module,
                     state: Dict[str, torch.Tensor]) -> Dict:
    """A whole state dict cut to this rank's shards of ``model``."""
    dims = getattr(model, "shard_dims", {})
    if not dims:
        return state
    return {k: (shard_of(v, "model", dims[k]).clone() if k in dims else v)
            for k, v in state.items()}


_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


def _sharded_indices(model: torch.nn.Module) -> Dict[int, int]:
    """Optimizer index -> split dim, for an optimizer built over
    ``model.parameters()``."""
    dims = getattr(model, "shard_dims", {})
    return {i: dims[name] for i, (name, _) in
            enumerate(model.named_parameters()) if name in dims}


def full_optimizer_state(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered whole (a collective)."""
    sd = optimizer.state_dict()
    idx = _sharded_indices(model)
    if not idx:
        return sd
    state = {}
    for i, s in sd["state"].items():
        if i in idx:
            s = {k: (all_gather(v, "model", idx[i]).cpu() if k in _MOMENTS
                     else v) for k, v in s.items()}
        state[i] = s
    return {**sd, "state": state}


def shard_optimizer_state(model: torch.nn.Module, sd: Dict) -> Dict:
    """A whole optimizer state dict cut to this rank's shards."""
    idx = _sharded_indices(model)
    if not idx:
        return sd
    state = {}
    for i, s in sd["state"].items():
        i = int(i)
        if i in idx:
            s = {k: (shard_of(v, "model", idx[i]).clone() if k in _MOMENTS
                     else v) for k, v in s.items()}
        state[i] = s
    return {**sd, "state": state}
