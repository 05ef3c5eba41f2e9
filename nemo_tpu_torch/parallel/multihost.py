"""Multi-process runtime: the process group and the tile slice of each
process.

Port of ``nemo_tpu/parallel/multihost.py``.  The reference spans nodes
with MPI; the JAX package brings up JAX's multi-controller runtime.  Here
one process runs on each host (or on each group of cards), and
``torch.distributed`` joins them:

* **Mesh** (:func:`.mesh.get_mesh`): each process's mesh is its own
  cards.  The global mesh is every process's mesh, in rank order.
* **Collectives**: the survey reductions of the sharded benchmark step
  (:func:`.distribute.make_sharded_tile_step`) all-reduce over the
  process group (MAX, then SUM) once they have reduced over the process's
  own shards.
* **Tiles**: :func:`local_tile_slice` is the JAX package's rule for the
  tiles a process would stage; :func:`is_coordinator` gates rank-0 work.
  As in the JAX package, nothing in the pipeline calls them yet: a
  single-host run never initialises the process group.

Launch contract (one process per host, torchrun's variables):

    NEMO_TPU_MULTIHOST=1 MASTER_ADDR=host0 MASTER_PORT=29500 \\
    WORLD_SIZE=N RANK=i \\
        python -m nemo_tpu_torch.cli.nemo_main config.yml

(``torchrun`` sets all but the first.)
"""

import os


def multihost_requested():
    """True when the launch environment asked for the multi-process
    runtime (NEMO_TPU_MULTIHOST=1)."""
    return os.environ.get("NEMO_TPU_MULTIHOST", "") not in ("", "0")


def initialize_from_env(device="cuda"):
    """Join the process group if requested: ``init_process_group`` from
    torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, over NCCL
    for ``device="cuda"`` and gloo for "cpu".  Must run before first
    device use.  No-op (returns False) when multi-process was not
    requested, so single-host runs never touch the distributed
    service."""
    if not multihost_requested():
        return False
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        if not os.environ.get(key):
            raise RuntimeError("NEMO_TPU_MULTIHOST=1 needs %s (torchrun "
                               "sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
                               "and RANK)" % key)
    dist.init_process_group(
        backend="nccl" if str(device).startswith("cuda") else "gloo",
        init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]))
    return True


def _group():
    """(rank, world size) of this process; (0, 1) with no process
    group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index():
    return _group()[0]


def is_coordinator():
    """Rank-0 gate for merge, stitch and summary outputs - the
    reference's rank-0 coordinator role (``nemo/startUp.py:389-404``)."""
    return process_index() == 0


def local_tile_slice(names, mesh):
    """The tiles of a chunk that THIS process stages: tile ``i`` goes to
    the process that owns position ``i mod n`` of the global mesh (every
    process's mesh, in rank order; ``n`` its size).  One process: all of
    them."""
    rank, world = _group()
    sizes = [mesh.size]
    if world > 1:
        import torch.distributed as dist
        sizes = [None] * world
        dist.all_gather_object(sizes, mesh.size)
    owner = [r for r, n in enumerate(sizes) for _ in range(n)]
    return [name for i, name in enumerate(names)
            if owner[i % len(owner)] == rank]
