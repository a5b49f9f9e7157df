"""The benchmark of the PyTorch and CUDA port (`repro_torch`): served CMAX
windows per second and latency tails on the batched and per-window
engines. Run a cell with

    python3 cmax_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that defines a cell is data found by name: `BENCHMARK.json` at
the root of the checkout lists the cells, `configs/<config>.json` holds a
deployment, `traffic/<mix>.json` a traffic mix and
`layer_metrics/<metric>.py` the reader of one per-layer metric. The
harness imports neither `jax` nor the JAX package `repro`; its plain
reference (`reference/`) imports nothing of the port either.
"""
