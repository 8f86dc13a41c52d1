"""Data parallelism over videos with ``torch.distributed``.

Twin of ``action_segmentation_tpu/parallel/mesh.py``. The JAX package
shards a batch's rows over the 'data' axis of a device mesh inside one
SPMD program; here each rank is a process with a replica of the
parameters and a slice of every batch's rows, joined by a process group
(NCCL when the ranks' tensors are on CUDA, gloo on the CPU). A batch is
padded to a multiple of the world size that is at least --batch_size
(``pad_batch_for_mesh``, JAX's padding: padded rows weigh 0) and rank r
takes rows [r * Bp / world, (r + 1) * Bp / world) (``shard_rows``).

The loss follows JAX's ``_make_local_loss``: each rank differentiates its
own weighted sums over the GLOBAL denominator (the batch's count of real
videos, known on the host), so the global gradient is the sum of the
ranks' (``all_reduce_grads``, one flat buffer a step). A
``DistributedDataParallel`` would average over the world size instead, a
different quantity. The loss terms are summed once an epoch
(``reduce_terms``); a decode's labels come together by one sum into a
buffer where the other ranks' rows are zero (``combine_rows``). Only
``all_reduce`` and ``broadcast`` are used: the two collectives gloo also
takes on CUDA tensors, so one path serves NCCL, gloo on the CPU and two
gloo ranks sharing one card. A failed collective raises; nothing here
catches it.

``run_ranks`` spawns a group of ranks on one host (the port's stand-in
for JAX's virtual CPU devices); a multi-card run starts one process a
card with ``torchrun``. Tensor parallelism over classes was retired in
the JAX package: ``model_parallel > 1`` raises. JAX's
``build_sharded_*`` builders are ``jit``/``shard_map`` program
factories and have no port: the model's loops call the functions here.
"""

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from action_segmentation_torch import resolve_device
from action_segmentation_torch.utils import logger

# a rank that waits longer than this in a collective raises
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


class Mesh(NamedTuple):
    """A data-parallel group: its process group, this rank, the world
    size and the device this rank's tensors live on. A process outside
    any group is the world-1 Mesh of ``single_mesh``: group None, whose
    collectives are the identity, so one code path serves both."""

    group: object
    rank: int
    world: int
    device: torch.device


class Shard(NamedTuple):
    """This rank's rows of one batch padded to `padded` rows (a multiple of
    the world size), of which the single path would have `single` (the
    rows a draw of the batch's noise covers)."""

    mesh: Mesh
    padded: int
    single: int

    @property
    def start(self):
        return rank_rows(self.mesh, self.padded)[0]

    @property
    def stop(self):
        return rank_rows(self.mesh, self.padded)[1]


def single_mesh(device):
    """The world-1 Mesh of a process outside any group: its collectives
    are the identity and its one rank holds every row."""
    return Mesh(None, 0, 1, torch.device(device))


def whole_batch(rows, device):
    """The Shard of a process outside any group: all `rows` of its batch."""
    return Shard(single_mesh(device), rows, rows)


def rank_rows(mesh, n):
    """This rank's rows [r * n / world, (r + 1) * n / world) of `n` (a
    multiple of the world size)."""
    if n % mesh.world:
        raise ValueError("{} rows do not split over {} ranks".format(n, mesh.world))
    per = n // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per


def _indexed(device):
    """`device` as a torch.device; a card without an index is the current
    card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices=None, model_parallel=1, device=None):
    """The data-parallel Mesh of the process group the caller made, or of
    one built from torchrun's RANK, WORLD_SIZE and LOCAL_RANK (NCCL when
    the device is a card, gloo on the CPU). `device` is this rank's:
    None takes cuda:LOCAL_RANK when this call makes the group (raising
    without a card, as ``resolve_device`` does: a CPU rank passes
    ``device="cpu"``), and in a group the caller made cuda under NCCL and
    the CPU under gloo. Raises when no group can be made, when the group
    does not have `n_devices` ranks, and for ``model_parallel > 1``
    (retired in the JAX package)."""
    if model_parallel not in (None, 1):
        raise NotImplementedError(
            "model_parallel={}: tensor parallelism over class tables was "
            "retired in the JAX package; use data parallelism".format(model_parallel)
        )
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "make_mesh: no process group and no torchrun environment; start "
                "one process a card with torchrun --nproc_per_node N, or call "
                "torch.distributed.init_process_group first"
            )
        if device is None:
            device = resolve_device(torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
        device = _indexed(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", timeout=COLLECTIVE_TIMEOUT)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and world != n_devices:
        raise RuntimeError(
            "make_mesh: requested {} ranks but the process group has {}".format(
                n_devices, world)
        )
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(dist.group.WORLD, rank, world, _indexed(device))


def data_parallel_mesh(device):
    """The Mesh --data_parallel runs on for a model on `device`. With a
    process group (or torchrun's environment) every rank joins it.
    Without one, exactly one visible device takes the single path (the
    world-1 ``single_mesh``), as JAX does on one device; several visible
    cards raise, naming the torchrun command that starts one rank a
    card."""
    device = torch.device(device)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return make_mesh(device=device)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if visible > 1:
        raise RuntimeError(
            "--data_parallel with {} visible cards and no process group: start one "
            "rank a card with torchrun --nproc_per_node {} -m "
            "action_segmentation_torch.main ...".format(visible, visible)
        )
    logger.debug("--data_parallel: no process group and one device ({}); the single "
                 "path".format(device))
    return single_mesh(device)


def process_rank():
    """This process's rank in its group (torchrun's RANK before the group
    exists); 0 outside any group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def _group_device():
    return _indexed("cuda" if dist.get_backend() == "nccl" else "cpu")


def barrier():
    """Hold every rank of the group until all reach it (a one-element
    all_reduce); a no-op outside any group."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=_group_device()))


def write_on_rank0(write, *args, **kwargs):
    """Call ``write(*args, **kwargs)`` on rank 0 alone (in every process
    outside a group), then hold the group until the write is done, so a
    rank that reads the file next finds it whole."""
    if process_rank() == 0:
        write(*args, **kwargs)
    barrier()


def pad_batch_for_mesh(mesh, arrays, batch_size, pad_to=None):
    """Pad leading batch dims (zeros) to Bp = ceil(max(batch_size, pad_to)
    / world) * world rows; returns (padded arrays, weights (Bp,): 1 for the
    `batch_size` real rows, then 0). JAX's padding exactly."""
    dp = mesh.world
    Bp = -(-max(batch_size, pad_to or 0) // dp) * dp
    padded = []
    for arr in arrays:
        arr = np.asarray(arr)
        if Bp > batch_size:
            arr = np.pad(arr, [(0, Bp - batch_size)] + [(0, 0)] * (arr.ndim - 1))
        padded.append(arr)
    weights = np.zeros(Bp, np.float32)
    weights[:batch_size] = 1.0
    return padded, weights


def shard_rows(mesh, x):
    """This rank's rows of `x` (``rank_rows``): the twin of
    ``batch_sharding``."""
    start, stop = rank_rows(mesh, x.shape[0])
    return x[start:stop]


def all_reduce(mesh, tensor, op=dist.ReduceOp.SUM):
    """``tensor`` reduced in place over the group by `op` (outside any
    group, as it is); returns it."""
    if mesh.group is not None:
        dist.all_reduce(tensor, op=op, group=mesh.group)
    return tensor


def replicate_module(mesh, module):
    """Every parameter and persistent buffer of `module` set to rank 0's
    (a broadcast each): the twin of ``replicated``/``shard_train_inputs``.
    Ranks start equal and, reducing the same gradients, stay equal."""
    if mesh.group is None:
        return
    with torch.no_grad():
        for tensor in module.state_dict().values():
            dist.broadcast(tensor, src=0, group=mesh.group)


def replicas_differ(mesh, module):
    """The names of `module`'s state-dict tensors that differ from rank
    0's on this rank, by ``torch.equal`` against a broadcast copy (none
    outside any group)."""
    differ = []
    if mesh.group is None:
        return differ
    for name, tensor in module.state_dict().items():
        copy = tensor.clone()
        dist.broadcast(copy, src=0, group=mesh.group)
        if not torch.equal(copy, tensor):
            differ.append(name)
    return differ


def all_reduce_grads(mesh, params):
    """Sum the gradients of `params` over the group, in one flat buffer (a
    parameter without a gradient has none on every rank: the ranks run one
    graph); outside any group they are the sum already."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh.group is None or not grads:
        return
    flat = all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset: offset + n].view_as(g))
        offset += n


def reduce_terms(mesh, terms):
    """A rank's loss-term sums summed over the group: the twin of
    ``_reduce_terms``."""
    return all_reduce(mesh, terms)


def terms_to_loss_aux(terms, den, use_labels):
    """(loss, aux) of summed terms (..., 3) = (nll, kl, log_det) weighted
    sums over `den` real videos, as ``_terms_to_loss_aux``: loss = nll -
    log_det, plus kl unsupervised; aux logs every component."""
    den = den.clamp(min=1.0)
    nll, kl, log_det = (terms[..., i] / den for i in range(3))
    loss = nll - log_det
    if not use_labels:
        loss = loss + kl
    return loss, {"nll": nll, "kl": kl, "log_det": log_det}


def shard_noise(shard, noise):
    """This rank's rows of a batch's noise drawn at the single path's
    shape (`shard.single` rows): padded with zero rows to the mesh's
    padded batch, then ``shard_rows``. A padded row weighs 0."""
    extra = shard.padded - noise.shape[0]
    if extra > 0:
        noise = torch.cat([noise, noise.new_zeros((extra,) + noise.shape[1:])])
    return shard_rows(shard.mesh, noise)


def batch_max(shard, value):
    """The batch's max of a rank's `value` (0-d): the twin of ``pmax``."""
    if shard.mesh.group is None:
        return value
    return all_reduce(shard.mesh, value.reshape(1).clone(), dist.ReduceOp.MAX)[0]


def combine_rows(mesh, local, padded):
    """The whole batch's (padded, ...) rows on every rank from each rank's
    `local` rows: one sum into a buffer where the other ranks' rows are
    zero (outside any group, `local` itself)."""
    if mesh.group is None:
        return local
    out = local.new_zeros((padded,) + tuple(local.shape[1:]))
    start, stop = rank_rows(mesh, padded)
    out[start:stop] = local
    return all_reduce(mesh, out)


# ----- spawning a group on one host -----

def _rank_main(rank, world, backend, store, device, fn, args, results):
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(_indexed(device))
        dist.init_process_group(backend, init_method="file://" + store, rank=rank,
                                world_size=world, timeout=COLLECTIVE_TIMEOUT)
        try:
            out = fn(make_mesh(world, device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world, *args, device=None, backend="gloo", timeout=900.0):
    """``fn(mesh, *args)`` on `world` spawned ranks of a new process group
    (`backend` over a ``file://`` store in a fresh temporary directory,
    each rank's tensors on `device`, None the CPU); returns the ranks'
    results in rank order, pickled by value (keep them on the CPU). `fn`
    must be importable by name. A rank that raises, dies or outlives
    `timeout` seconds ends every rank and raises here with its traceback.
    Two ranks on one card need gloo: NCCL refuses a card twice."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="aseg_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world, backend, store, device, fn, args, results))
                 for rank in range(world)]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        failure = "rank process exited with code {}".format(dead[0].exitcode)
                    elif datetime.datetime.now() > deadline:
                        failure = "ranks did not finish in {} s".format(timeout)
                    continue
                if ok:
                    out[rank] = pickle.loads(payload)
                else:
                    failure = "rank {} failed:\n{}".format(rank, payload)
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=60)
    if failure is not None:
        raise RuntimeError("run_ranks({}, world={}): {}".format(
            getattr(fn, "__name__", fn), world, failure))
    return [out[r] for r in range(world)]
