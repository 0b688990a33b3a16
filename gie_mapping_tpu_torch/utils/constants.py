"""Shared constants of the PyTorch port (a copy of
gie_mapping_tpu/utils/constants.py: the two packages must agree on every
value, and importing the JAX package's copy would pull in JAX).

Semantics mirror the reference engine's voxel taxonomy and sentinels
(reference include/map_structure/local_batch.h:7-10,
 include/par_wave/voxmap_utils.cuh:8-27).
"""

# Voxel types (reference: local_batch.h:7-10)
VOX_UNKNOWN = 0
VOX_FREE = 1
VOX_OCCUPIED = 2
VOX_FNT = 3  # exploration frontier

# Sentinel "infinite" squared distance (reference: voxmap_utils.cuh:8)
EMPTY_VALUE = 999_999

# Voxel-block geometry (reference: voxmap_utils.cuh:10-11)
VB_WIDTH = 8
VB_SIZE = VB_WIDTH ** 3

# Invalid closest-obstacle-coordinate sentinel for int32 coordinate triples.
# The reference packs cocs into 11/11/10-bit fields and uses out-of-range
# values as invalid markers (local_batch.h:59); we store coc as plain int32
# triples so a single large sentinel suffices.
INVALID_COC = EMPTY_VALUE

# Default low-pass fusion constants (reference: unify_helper.cuh:91-96,170-177)
OCC_HIT_VAL = 250.0
OCC_FREE_VAL = 0.0
LOWPASS_SENSOR_OCC = 0.8
LOWPASS_SENSOR_FREE = 0.5
OCC_VAL_MAX = 254.0  # UCHAR_MAX - 1
OCC_VAL_MIN = 1.0

# Sensor gates (reference: hokuyo_fast.cu:55-67, realsense_fast.cu:47-57,
# vlp16_fast.cu:58-77)
SENS_FAR_DIST = 100.0
