from .mesh import (MESH_AXIS, Mesh, all_to_all, gather_x, make_mesh,
                   shard_global_map, shard_state, split_x)
