"""The benchmark of the PyTorch + CUDA port (`dawnsearch_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card: it makes the
cell's inputs from the seed, starts the port's node as a user starts it,
drives it over HTTP, and prints one JSON result line. See README.md.
"""
