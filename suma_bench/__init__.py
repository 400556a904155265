"""The benchmark of ``semantic_suma_tpu_torch`` on one NVIDIA H100: one cell
(a configuration under a traffic mix, named in ``BENCHMARK.json``) run once
by ``python3 -m suma_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. Configurations, traffic mixes, per-layer metric readers and
the limits of each cell's check are files of their own, found by name."""
