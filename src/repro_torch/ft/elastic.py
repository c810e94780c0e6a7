"""Elastic scaling: re-shard a live (or restored) state onto a new mesh.

Checkpoints store logical arrays (full shapes); restore targets carry the
NEW topology's shardings, so growing 256 -> 512 chips (or shrinking after
losing a pod) is a restore with a different rules/mesh pair — no format
change. This module also reshards in-memory trees for mid-job elasticity
and persists post-reshard snapshots through the write-behind checkpoint
path so the (expensive) resize is immediately crash-safe.

The port of the JAX package's ``ft/elastic.py`` on `torch.distributed`:
a sharding is a `repro_torch.sharding.rules.NamedSharding` (a mesh and one
placement per mesh dimension), a sharded leaf a `DTensor`, and each
function here is called on every rank of the mesh.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree as T
from repro_torch.io import IOPolicy
from repro_torch.models.spec import param_shardings
from repro_torch.sharding.rules import ShardingRules


def _reshard(x, sharding):
    if sharding is None:
        # device_put(x, None): the logical array, replicated.
        return x.full_tensor() if isinstance(x, DTensor) else x
    if isinstance(x, DTensor):
        if x.device_mesh == sharding.mesh:
            return x.redistribute(sharding.mesh, sharding.placements)
        x = x.full_tensor()     # another mesh: through the logical array
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


def reshard_tree(tree, shardings):
    """Lay every leaf out on the paired sharding (None = replicate): a
    `DTensor` is redistributed, a plain tensor (the same global value on
    every rank) distributed with no communication."""
    return T.map_leaves(_reshard, tree, shardings)


def reshard_params(params, spec_tree, rules: ShardingRules):
    """Re-shard a parameter tree onto `rules.mesh` per the declarative spec."""
    return reshard_tree(params, param_shardings(spec_tree, rules))


def snapshot_resharded(
    store,
    prefix: str,
    step: int,
    tree,
    shardings,
    *,
    extra: dict | None = None,
    policy: IOPolicy | None = None,
) -> dict:
    """Reshard `tree` onto `shardings` and persist it as a checkpoint.

    After an elastic resize the first post-reshard snapshot is the new
    recovery point — losing it replays the whole resize. Uploads go
    through the pipelined `save_checkpoint` (write-behind; manifest-last
    commit), so the snapshot costs max(T_reshard, T_upload) instead of
    their sum. `store` may be an `ObjectStore`, `PrefetchFS`, or URI.
    """
    from repro_torch.ckpt.manager import save_checkpoint

    resharded = reshard_tree(tree, shardings)
    return save_checkpoint(store, prefix, step, resharded,
                           extra=extra, policy=policy)


def restore_resharded(
    store,
    prefix: str,
    template,
    *,
    host_id: int,
    num_hosts: int,
    step: int | None = None,
    policy: IOPolicy | None = None,
    **kw,
):
    """Mesh-sharded restore for an elastic topology change: delegates to
    ``restore_checkpoint(shard=(host_id, num_hosts))``, so each host of
    the NEW mesh warms only its rendezvous-owned slice of the checkpoint
    stream and fills the rest from siblings when `store` routes through a
    ``peer://`` group.

    This is how a replacement host after a failure warms cheaply: the
    survivors still hold (and serve) their shards from the previous
    restore, so the newcomer's full-stream read costs ~its own shard in
    backing-store traffic — everything else arrives over the LAN. The
    ``shard`` ids must be the mesh's ``(rank, world_size)`` (see
    ``repro_torch.launch.mesh.mesh_host_shard``) so the warmed blocks line
    up with where the peer group routes requests for them. A `DTensor`
    leaf of `template` lays its restored leaf out on its own mesh.
    """
    from repro_torch.ckpt.manager import restore_checkpoint

    return restore_checkpoint(store, prefix, template, step=step,
                              policy=policy, shard=(host_id, num_hosts),
                              **kw)
