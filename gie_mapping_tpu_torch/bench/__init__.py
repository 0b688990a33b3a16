"""The port's benchmark harnesses, one module for each of the JAX
package's root scripts and for the scripts of its examples/ that the port
carries:

  headline  bench.py          the cow-lady replay, timed (one JSON line)
  suite     bench_suite.py    the six preset cases with tail-latency stage
                              costs (a JSON line each, then a summary)
  scaling   bench_scaling.py  merge ms/frame by device count
  parts     examples/bench_{frame,merge,raycast,edt,scroll}_parts.py,
            bench_scroll_bisect.py, bench_dispatch.py: the time of each
            stage of a frame (a JSON line per group)
  teleport  examples/bench_teleport.py: jumps of 3 window extents
  ab        examples/bench_edt_gate_ab.py (gate, p1c),
            bench_gate_rung_ab.py, bench_relax_ab.py

Each runs as `python -m gie_mapping_tpu_torch.bench.<name>`, on the card
unless `--cpu` is given (and raises without one), and times on the
device clock (CUDA events); each JSON line names the card by its
`nvidia-smi` name and power limit, or says "cpu".
"""
