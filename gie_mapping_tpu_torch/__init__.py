"""PyTorch + CUDA port of the GIE mapping engine (for NVIDIA H100 cards).

The JAX package `gie_mapping_tpu` beside it stays the reference: every
module here names its counterpart there, and tests/test_torch_*.py hold the
two bit for bit on the CPU.  This package imports PyTorch and never JAX.

Layer map:
  models/    VolumetricMapper (process_pointcloud) and the per-frame merge
  ops/       sensor model, fusion, EDT chain (one device or sharded),
             frontiers
  ops/kernels/  wrappers of the hand-written CUDA kernels in csrc/, each
             beside its plain PyTorch version (used for CPU tensors)
  parallel/  the device mesh: the map state sharded between frames (the
             canvas along x, the archive along blocks) over one process or
             a torch.distributed group; the multi-process demo
  map_state  canvas + archive state, the canvas scroll, stream extraction
  runtime/   synthetic worlds and the host mirror of streamed blocks (numpy)
  utils/     config, geometry, constants
"""

from .utils import constants
from .utils.config import PRESETS, MapConfig, load_config, load_config_yaml

__version__ = "0.1.0"


def create_mapper(case: str = "cow_lady", device=None, mesh=None,
                  **overrides):
    """One-call engine construction for a case preset on `device`
    ("cuda", "cpu", a torch.device; default "cuda", which raises when no
    card is available) or over `mesh` (parallel.mesh.make_mesh)."""
    from .models.mapper import VolumetricMapper

    return VolumetricMapper(load_config(case, **overrides), device=device,
                            mesh=mesh)
