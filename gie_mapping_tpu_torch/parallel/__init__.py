from .mesh import (MESH_AXIS, Mesh, Sharded, all_reduce, all_to_all,
                   canvas_sharding, gather, make_mesh, pool_sharding,
                   replicated, shard_global_map, shard_state)
