"""The client mesh on torch.distributed (port of fedmse_tpu/parallel/):
the mesh and its placement (mesh.py), joining a launch and the host-side
control plane (multihost.py), the merge's collectives (collectives.py),
the int8 codec (quantize.py) and the byte accounting with the measured
merge plan (costmodel.py)."""

from fedmse_tpu_torch.parallel.collectives import (
    host_groups, make_clustered_hierarchical_aggregate,
    make_clustered_shardmap_aggregate, make_hierarchical_aggregate,
    make_shardmap_aggregate, make_shardmap_divergence, rank_sum,
    sharded_weighted_mean)
from fedmse_tpu_torch.parallel.costmodel import (merge_profile, plan_merge,
                                                 seam)
from fedmse_tpu_torch.parallel.mesh import (ClientMesh, client_mesh,
                                            default_mesh, host_fetch,
                                            host_fetch_async,
                                            local_shard_rows,
                                            mesh_process_indices,
                                            my_tier_block, pad_to_multiple,
                                            place_cohort, process_client_rows,
                                            process_tier_blocks, replicate,
                                            shard_clients, shard_federation)
from fedmse_tpu_torch.parallel.multihost import (allgather_blocks,
                                                 allgather_tree_sum)
from fedmse_tpu_torch.parallel.multihost import initialize as \
    initialize_multihost
from fedmse_tpu_torch.parallel.multihost import uniform_decision

__all__ = [
    "ClientMesh", "allgather_blocks", "allgather_tree_sum", "client_mesh",
    "default_mesh", "host_fetch", "host_fetch_async", "host_groups",
    "initialize_multihost", "local_shard_rows",
    "make_clustered_hierarchical_aggregate",
    "make_clustered_shardmap_aggregate", "make_hierarchical_aggregate",
    "make_shardmap_aggregate", "make_shardmap_divergence", "merge_profile",
    "mesh_process_indices", "my_tier_block", "pad_to_multiple",
    "place_cohort", "plan_merge", "process_client_rows",
    "process_tier_blocks", "rank_sum", "replicate", "seam", "shard_clients",
    "shard_federation", "sharded_weighted_mean", "uniform_decision",
]
