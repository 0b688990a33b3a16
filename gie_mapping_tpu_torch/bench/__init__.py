"""The port's benchmark harnesses, one module for each of the JAX
package's root scripts:

  headline  bench.py          the cow-lady replay, timed (one JSON line)
  suite     bench_suite.py    the six preset cases with tail-latency stage
                              costs (a JSON line each, then a summary)
  scaling   bench_scaling.py  merge ms/frame by device count

Each runs as `python -m gie_mapping_tpu_torch.bench.<name>`, on the card
unless `--cpu` is given (and raises without one), and times on the
device clock (CUDA events); each JSON line names the card by its
`nvidia-smi` name and power limit, or says "cpu".
"""
