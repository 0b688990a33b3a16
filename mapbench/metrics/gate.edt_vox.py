"""Voxels of the EDT the change gate chose, per gated merge (the engine's
counter gate.slab_vox: a slab of the menu, the whole canvas, or 0 for the
constant fill of a canvas without sites)."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean("gate.slab_vox") if p is not None else None
